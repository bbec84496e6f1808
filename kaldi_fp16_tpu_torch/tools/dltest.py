"""dltest: the DataLoader over ark files with global stats, frames/s and
the bf16 round-trip error of the features.

The twin of tools/dltest.py: the in-line DataLoader, MultiPrefetchLoader
(--workers N parser threads over file shards) or ProcessLoader
(--process-workers N processes).  The bf16 cast is torch.bfloat16 on the
host, which rounds to nearest even as the JAX tool's cast does, so the
error is the JAX tool's bit for bit.  Host only: no device.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.dltest 'egs/cegs.*.ark' [--batch 8]
      [--label-dim 0] [--feat-dim 40] [--ivector-dim 100] [--workers N]
      [--process-workers N] [--no-bf16-check]

`main(argv)` returns {"batches", "frames", "frames_per_s",
"steady_frames_per_s", "feature_range", "bf16_max_err"}.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.io.dataloader import (
    DataLoader, DataLoaderConfig, MultiPrefetchLoader, ProcessLoader,
)


def bf16_round_trip_err(features: np.ndarray) -> float:
    """max |bf16(x) - x| of a feature array, cast on the host."""
    x = torch.from_numpy(features)
    return float((x.to(torch.bfloat16).float() - x).abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.dltest",
        description=__doc__.split("\n")[0])
    ap.add_argument("pattern")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--label-dim", type=int, default=0)
    ap.add_argument("--feat-dim", type=int, default=40)
    ap.add_argument("--ivector-dim", type=int, default=100)
    ap.add_argument("--workers", type=int, default=0,
                    help="N parser threads via MultiPrefetchLoader "
                         "(0 = single in-line DataLoader)")
    ap.add_argument("--process-workers", type=int, default=0,
                    help="N parser processes via ProcessLoader (scales "
                         "the GIL-held batch assembly too)")
    ap.add_argument("--no-bf16-check", action="store_true",
                    help="skip the per-batch bf16 round-trip check")
    args = ap.parse_args(argv)

    cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.label_dim,
                           feat_dim=args.feat_dim,
                           ivector_dim=args.ivector_dim)
    if args.process_workers > 0:
        dl = ProcessLoader(args.pattern, cfg, workers=args.process_workers)
    elif args.workers > 0:
        dl = MultiPrefetchLoader(args.pattern, cfg, workers=args.workers)
    else:
        dl = DataLoader(args.pattern, cfg)
    t0 = time.perf_counter()
    t_first = None
    n_batches = total_frames = frames_first = 0
    bf16_max_err = 0.0
    fmin, fmax = np.inf, -np.inf
    try:
        for batch in dl:
            frames = batch.features.shape[0] * batch.features.shape[1]
            if t_first is None:
                t_first = time.perf_counter()
                frames_first = frames
            n_batches += 1
            total_frames += frames
            fmin = min(fmin, float(batch.features.min()))
            fmax = max(fmax, float(batch.features.max()))
            if not args.no_bf16_check:
                bf16_max_err = max(bf16_max_err,
                                   bf16_round_trip_err(batch.features))
    finally:
        if hasattr(dl, "close"):
            dl.close()
    t_end = time.perf_counter()
    dt = t_end - t0
    print(dl.summary())
    fps = total_frames / max(dt, 1e-9)
    print(f"batches={n_batches} frames={total_frames} "
          f"({fps:,.0f} frames/s parse+assemble)")
    steady = None
    if t_first is not None and n_batches > 1:
        steady = (total_frames - frames_first) / max(t_end - t_first, 1e-9)
        print(f"steady-state (excl. startup+first batch): {steady:,.0f} "
              f"frames/s")
    print(f"feature range [{fmin:.3f}, {fmax:.3f}], "
          f"bf16 round-trip max |err| = {bf16_max_err:.3e}")
    return {"batches": n_batches, "frames": total_frames,
            "frames_per_s": fps, "steady_frames_per_s": steady,
            "feature_range": (fmin, fmax), "bf16_max_err": bf16_max_err}


if __name__ == "__main__":
    main()
