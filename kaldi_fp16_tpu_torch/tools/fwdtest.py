"""fwdtest: the eval forward on an xconfig and a cegs batch (or random
inputs): per-output shapes, finiteness, mean / std, and frames/s.

The twin of tools/fwdtest.py, on --device (default: the current CUDA
device), with a device sync before each clock read.  --bn-identity swaps
models/network._batchnorm for an identity, as the JAX tool does: the
upper bound of any BN-folding gain, for timing only (its outputs are
wrong).  Weights come from a seed-0 CPU generator.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.fwdtest [--xconfig F] [--egs PATTERN]
      [--batch 8] [--frames 150] [--iters 20] [--bn-identity] [--device cpu]

`main(argv)` returns {"outputs": {name: {shape, finite, mean, std}},
"frames_per_s", "seconds"}.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.models import network as net_module
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.fwdtest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--xconfig",
                    default=str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    ap.add_argument("--egs", help="cegs ark glob (default: random inputs)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bn-identity", action="store_true",
                    help="replace every batchnorm with identity: the upper "
                         "bound of any BN eval-folding gain; outputs are "
                         "numerically wrong, timing only")
    device_arg(ap, "the forward")
    args = ap.parse_args(argv)
    dev = tool_device("fwdtest", args.device)

    batchnorm = net_module._batchnorm
    if args.bn_identity:
        net_module._batchnorm = lambda x, st, *a, **k: (x, st)
        print("bn-identity: batchnorm replaced by identity (timing-only run)")
    try:
        return run(args, dev)
    finally:
        net_module._batchnorm = batchnorm


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, dev) -> dict:
    model = build_model(args.xconfig)
    print(model.summary())
    net = net_module.Network(model, torch.Generator().manual_seed(0), dev)
    net.eval()

    feat_dim = model.layer_map["input"].output_dim
    has_ivec = "ivector" in model.layer_map
    ivec_dim = model.layer_map["ivector"].output_dim if has_ivec else 0

    if args.egs:
        from kaldi_fp16_tpu_torch.io.dataloader import (
            DataLoader, DataLoaderConfig,
        )
        dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch,
                                                   feat_dim=feat_dim,
                                                   ivector_dim=ivec_dim))
        batch = next(iter(dl))
        feats = torch.from_numpy(batch.features).to(dev)
        ivecs = (torch.from_numpy(batch.ivectors).to(dev)
                 if has_ivec and batch.ivectors is not None else None)
        print(f"loaded batch: {batch.features.shape} "
              f"keys={batch.keys[:3]}...")
    else:
        rng = np.random.default_rng(0)
        feats = torch.from_numpy(rng.normal(
            size=(args.batch, args.frames, feat_dim)).astype(np.float32)
        ).to(dev)
        ivecs = (torch.from_numpy(rng.normal(
            size=(args.batch, ivec_dim)).astype(np.float32)).to(dev)
            if has_ivec else None)

    def fwd():
        with torch.no_grad():
            outs, _ = net(feats, ivecs, train=False)
        return outs

    outs = fwd()
    sync(dev)
    report = {}
    for name, o in outs.items():
        arr = o.float().cpu().numpy()
        rec = dict(shape=tuple(o.shape), finite=bool(np.isfinite(arr).all()),
                   mean=float(arr.mean()), std=float(arr.std()))
        report[name] = rec
        print(f"output {name}: {rec['shape']} finite={rec['finite']} "
              f"mean={rec['mean']:.4f} std={rec['std']:.4f}")

    t0 = time.perf_counter()
    for _ in range(args.iters):
        outs = fwd()
    sync(dev)
    dt = time.perf_counter() - t0
    B, T = feats.shape[:2]
    fps = B * T * args.iters / dt
    print(f"throughput: {fps:,.0f} frames/s")
    return {"outputs": report, "frames_per_s": fps, "seconds": dt}


if __name__ == "__main__":
    main()
