"""gputest: the data pipeline's transfer to the card: parse time, a
batch's arrays host -> card (pageable and pinned), the raw transfer rate,
the fp16 / bf16 conversion audit of the features, and an fp32 round trip
that must be bit-exact.

The twin of tools/gputest.py on --device (default: the current CUDA
device).  Each copy is timed on the host clock up to a device sync;
pinned copies are issued with non_blocking=True from page-locked host
tensors (pin_memory()).  On the CPU (--device cpu) the copies are host
copies and pinned memory is not measured.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.gputest [--egs PATTERN]
      [--pdfs 48] [--batch 8] [--iters 10] [--mb 64] [--device cpu]

`main(argv)` returns {"parse_ms", "batch_mb", "batch_ms": {pageable,
pinned}, "raw_gb_per_s": {pageable, pinned}, "audit": {fmt: stats},
"bit_exact"}; run as a program it exits 1 unless the round trip is
bit-exact.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device


def timed_copy(host, dev, iters, pinned):
    """Mean seconds to copy the host tensors to `dev`, synced."""
    def once():
        out = [t.to(dev, non_blocking=pinned, copy=True) for t in host]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    for _ in range(2):      # warm up
        once()
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.gputest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--egs")
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mb", type=float, default=64.0,
                    help="payload size for the raw transfer benchmark")
    device_arg(ap, "the transfers")
    args = ap.parse_args(argv)
    dev = tool_device("gputest", args.device)

    from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu_torch.utils.lowp import analyze_conversion

    if not args.egs:
        from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
        tmp = tempfile.mkdtemp(prefix="gputest_")
        make_synthetic_egs.main([tmp, "--pdfs", str(args.pdfs)])
        args.egs = f"{tmp}/cegs.*.ark"

    # 1. parse throughput
    t0 = time.perf_counter()
    dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch,
                                               label_dim=args.pdfs))
    batches = list(dl)
    parse_s = time.perf_counter() - t0
    n_ex = dl.stats.examples_read
    print(f"parse: {n_ex} examples -> {len(batches)} batches "
          f"in {parse_s*1e3:.1f} ms ({n_ex/max(parse_s,1e-9):.0f} ex/s)")
    if not batches:
        raise SystemExit("error: no batches")

    # 2. one batch's arrays (features, ivectors, numerator graph)
    b = batches[0]
    g = b.num_graph
    arrays = [b.features, b.ivectors, g.arc_src, g.arc_dst, g.arc_pdf,
              g.arc_logw, g.arc_mask, g.final_logw]
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays if a is not None]
    nbytes = sum(t.numel() * t.element_size() for t in host)
    cuda = dev.type == "cuda"
    batch_s = {"pageable": timed_copy(host, dev, args.iters, False)}
    if cuda:
        pinned = [t.pin_memory() for t in host]
        batch_s["pinned"] = timed_copy(pinned, dev, args.iters, True)
    for kind, dt in batch_s.items():
        print(f"batch transfer ({kind}): {nbytes/1e6:.2f} MB in "
              f"{dt*1e3:.2f} ms ({nbytes/dt/1e9:.2f} GB/s)")

    # 3. raw large-payload transfer (the bandwidth ceiling)
    big = torch.from_numpy(np.random.default_rng(0).random(
        (int(args.mb * 1e6 / 4),), np.float32))
    big_bytes = big.numel() * 4
    raw_s = {"pageable": timed_copy([big], dev, 3, False)}
    if cuda:
        raw_s["pinned"] = timed_copy([big.pin_memory()], dev, 3, True)
    for kind, dt in raw_s.items():
        print(f"raw transfer ({kind}): {big_bytes/1e6:.0f} MB in "
              f"{dt*1e3:.1f} ms ({big_bytes/dt/1e9:.2f} GB/s)")

    # 4. low-precision round-trip audit on the real features
    feats = np.concatenate([bb.features.reshape(-1) for bb in batches[:4]])
    audit = {}
    for fmt in ("float16", "bfloat16"):
        st = analyze_conversion(feats, fmt=fmt)
        audit[fmt] = dataclasses.asdict(st)
        print(f"{fmt} round-trip: max_abs_err={st.max_abs_err:.3e} "
              f"avg_abs_err={st.avg_abs_err:.3e} overflow={st.overflow} "
              f"underflow={st.underflow}")

    # 5. fp32 host -> device -> host must be bit-exact
    x = feats[:1 << 16]
    back = torch.from_numpy(x).to(dev).cpu().numpy()
    ok = bool(np.array_equal(back, x))
    print(f"fp32 device round-trip bit-exact: {ok}")
    print("PASS" if ok else "FAIL")
    return {"parse_ms": parse_s * 1e3, "batch_mb": nbytes / 1e6,
            "batch_ms": {k: v * 1e3 for k, v in batch_s.items()},
            "raw_gb_per_s": {k: big_bytes / v / 1e9
                             for k, v in raw_s.items()},
            "audit": audit, "bit_exact": ok}


if __name__ == "__main__":
    sys.exit(0 if main()["bit_exact"] else 1)
