"""chaintest: end-to-end chain loss smoke test: model -> forward ->
per-sequence subsample -> num / den forward-backward -> batch loss ->
derivative health (NaN, Inf, share of zeros, row sums, NaN containment)
and device memory.

The twin of tools/chaintest.py, on --device (default: the current CUDA
device) with TF32 off.  With no --egs it writes synthetic cegs (the
port's tools.make_synthetic_egs) into a temporary directory.  Weights
come from a seed-0 CPU generator, so the card and the CPU start alike.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.chaintest [--egs PATTERN
      --den-fst F] [--xconfig F] [--pdfs 48] [--batch 4] [--device cpu]

`main(argv)` returns {"failures", "objf_per_frame", "num", "den", "ok",
"deriv": {shape, nan, inf, nonzero, min, max, max_row_sum},
"memory_mb": {in_use, peak} or None}; run as a program it exits 1 on a
failure.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device

TINY_XCONFIG = """\
input name=ivector dim=100
input name=input dim=40
relu-batchnorm-layer name=tdnn1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=64
tdnnf-layer name=tdnnf2 dim=64 bottleneck-dim=16 time-stride=3
prefinal-layer name=prefinal-chain input=tdnnf2 big-dim=64 small-dim=32
output-layer name=output include-log-softmax=false dim={pdfs}
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.chaintest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--egs")
    ap.add_argument("--den-fst")
    ap.add_argument("--xconfig")
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = tool_device("chaintest", args.device)

    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.objective import (
        ChainTrainingOpts, chain_core,
    )
    from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    from kaldi_fp16_tpu_torch.models.model import (
        build_model, build_model_from_string,
    )
    from kaldi_fp16_tpu_torch.models.network import Network, subsample_output
    from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs

    if not args.egs:
        tmp = tempfile.mkdtemp(prefix="chaintest_")
        make_synthetic_egs.main([tmp, "--pdfs", str(args.pdfs)])
        args.egs = f"{tmp}/cegs.*.ark"
        args.den_fst = f"{tmp}/den.fst"

    if args.xconfig:
        model = build_model(args.xconfig)
    else:
        model = build_model_from_string(TINY_XCONFIG.format(pdfs=args.pdfs))
    print(model.summary())
    net = Network(model, torch.Generator().manual_seed(0), dev)
    net.eval()

    den_graph = DenominatorGraph.from_fst(read_fst_file(args.den_fst),
                                          args.pdfs)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with fp32_matmuls():
        den = DenominatorComputation(den_graph, leaky=1e-5, device=dev)
        print(f"den graph: {den_graph.num_states} states, "
              f"{den_graph.num_transitions} transitions")

        dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch,
                                                   label_dim=args.pdfs))
        batch = next(iter(dl))
        feats = torch.from_numpy(batch.features).to(dev)
        ivecs = (torch.from_numpy(batch.ivectors).to(dev)
                 if batch.ivectors is not None else None)
        print(f"batch: features {tuple(feats.shape)}, frames_per_seq "
              f"{batch.frames_per_seq}, left_context {batch.left_context}")

        with torch.no_grad():
            outs, _ = net(feats, ivecs, train=False)
        out = subsample_output(outs["output"], 3, batch.left_context,
                               batch.frames_per_seq)
        result, deriv, _ = chain_core(
            batch.num_graph, den, out,
            torch.from_numpy(batch.weights).to(dev),
            opts=ChainTrainingOpts())
    d = deriv.cpu().numpy()
    ok = result.ok.cpu().numpy()
    num = float(result.num_logprob.mean())
    den_lp = float(result.den_logprob.mean())
    objf = float(result.objf_per_frame)
    print(f"objf/frame = {objf:.6f}  num = {num:.4f}  den = {den_lp:.4f}  "
          f"ok = {ok.tolist()}")

    failures = 0
    n_nan, n_inf = int(np.isnan(d).sum()), int(np.isinf(d).sum())
    nonzero = float((d != 0).mean())
    print(f"deriv: shape {d.shape}, NaN={n_nan}, Inf={n_inf}, "
          f"nonzero={nonzero:.1%}, range=[{d.min():.4f}, {d.max():.4f}]")
    if n_nan or n_inf:
        print("FAIL: non-finite gradient values")
        failures += 1
    if nonzero < 0.05:
        print("FAIL: gradient almost entirely zero")
        failures += 1
    if not bool(ok.all()):
        print("FAIL: NaN containment fired")
        failures += 1
    # num-post minus den-post rows sum to ~0 per frame (both are
    # distributions) up to the out-of-range penalty
    row_sums = float(np.abs(d.sum(axis=2)).max())
    print(f"max |sum_p deriv[b,t,:]| = {row_sums:.4e} (should be small)")

    memory = None
    if dev.type == "cuda":
        memory = {"in_use": torch.cuda.memory_allocated(dev) / 1e6,
                  "peak": torch.cuda.max_memory_allocated(dev) / 1e6}
        print(f"device memory: {memory['in_use']:.1f} MB in use, "
              f"{memory['peak']:.1f} MB peak")

    print("PASS" if failures == 0 else f"FAIL ({failures})")
    return {"failures": failures, "objf_per_frame": objf, "num": num,
            "den": den_lp, "ok": ok.tolist(),
            "deriv": {"shape": d.shape, "nan": n_nan, "inf": n_inf,
                      "nonzero": nonzero, "min": float(d.min()),
                      "max": float(d.max()), "max_row_sum": row_sums},
            "memory_mb": memory}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
