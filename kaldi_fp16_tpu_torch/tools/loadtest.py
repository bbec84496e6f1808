"""loadtest: Kaldi model import into the port's network: the xconfig
summary and execution order, the import, a forward sanity check.

The twin of tools/loadtest.py.  With --model pointing at a Kaldi model
file (binary .mdl / .raw, read standalone, or `nnet3-copy --binary=false`
text) it loads that into a network built from --xconfig; without it, it
exports a seed-0 network to nnet3 text, writes that text as a binary .raw
and loads the .raw into a seed-1 network (the text and the binary
container both on the path).  Then it runs the eval forward on --device
(default: the current CUDA device) and prints what the JAX tool prints.
The round trip is held bit for bit (the JAX tool's bar is 2e-2): the
loaded network's outputs must equal the exported network's.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.loadtest [--xconfig F] \\
      [--model final.mdl|nnet3.txt] [--batch 2] [--frames 30] [--device cpu]

`main(argv)` returns {"report": values loaded per layer, "outputs":
{name: shape}, "round_trip_max_abs_err": float or None, "failures": n};
run as a program it exits 1 on a failure.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.loadtest")
    ap.add_argument("--xconfig",
                    default=str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    ap.add_argument("--model",
                    help="Kaldi model: binary .mdl/.raw or nnet3 text")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.models.kaldi_loader import (
        export_network_text, load_into_network, text_to_binary,
    )
    from kaldi_fp16_tpu_torch.models.model import build_model
    from kaldi_fp16_tpu_torch.models.network import Network

    device = resolve_device(args.device)
    model = build_model(args.xconfig)
    print(model.summary())
    print("execution order:",
          " -> ".join(l.name for l in model.execution_order()))

    def network(seed):
        net = Network(model, torch.Generator(device=device).manual_seed(seed),
                      device)
        net.eval()
        return net

    source, net = network(0), network(1)
    if args.model:
        report = load_into_network(net, args.model)
    else:
        print("no --model given: round-tripping the exporter's own output "
              "through BOTH the text and binary containers")
        with tempfile.TemporaryDirectory() as d:
            bpath = os.path.join(d, "roundtrip.raw")
            text_to_binary(export_network_text(source), bpath)
            report = load_into_network(net, bpath)
    total = sum(report.values())
    print(f"loaded {total:,} values into {len(report)} layers:")
    for name, n in report.items():
        print(f"  {name:24s} {n:>10,}")

    rng = np.random.default_rng(0)
    feat_dim = model.layer_map["input"].output_dim
    feats = torch.from_numpy(rng.normal(size=(
        args.batch, args.frames, feat_dim)).astype(np.float32)).to(device)
    ivecs = None
    if "ivector" in model.layer_map:
        ivecs = torch.from_numpy(rng.normal(
            size=(args.batch, model.layer_map["ivector"].output_dim))
            .astype(np.float32)).to(device)
    with torch.no_grad():
        outs, _ = net(feats, ivecs, train=False)
    failures = 0
    for name, out in outs.items():
        o = out.cpu().numpy()
        finite = bool(np.isfinite(o).all())
        print(f"output {name}: shape {o.shape}, "
              f"range [{o.min():.3f}, {o.max():.3f}], finite={finite}")
        if not finite:
            failures += 1
    err = None
    if not args.model:
        # the round trip must reproduce the exported network's forward
        with torch.no_grad():
            outs0, _ = source(feats, ivecs, train=False)
        err = max(float((outs0[k] - outs[k]).abs().max()) for k in outs)
        print(f"round-trip forward max |err| = {err:.2e}")
        if err != 0.0:
            failures += 1
    print("PASS" if failures == 0 else f"FAIL ({failures})")
    return {"report": report,
            "outputs": {k: tuple(v.shape) for k, v in outs.items()},
            "round_trip_max_abs_err": err, "failures": failures}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
