"""Where the den's time goes: per-kernel times under torch.profiler, and
the scans' matmuls, forward() and forward_backward() per implementation.

    python -m kaldi_fp16_tpu_torch.tools.profile_den [--batch 128]
        [--frames 49] [--pdfs 3080] [--split kernel|pre]
        [--impls high,fused] [--iters 10] [--device cpu]

At bench.py's den geometry (the 7052-state phone-LM graph, F = 3526
chains, N = --batch sequences, T = --frames), it first profiles one
call of each: a den_matmul application (M^T @ v, n = N), a fused forward
scan, a fused backward scan, the default den's forward-backward, and the
same graph's forward-backward forced to the blocked layout (its default
posterior reduce: the segment_reduce kernel on a card), and prints one
JSON line per call with the device microseconds of every kernel by name
(total and per launch), sorted by total.  Each call runs once
unprofiled first, so the kernels are built and warm.

Then, as tools/profile_den.py does, for each of --impls (the JAX tool's
names) three wall-clock means over --iters calls after one warm-up, each
call ended by a sync of its outputs' device (utils.profiling.profile_fn):

  scan_matmuls_ms  the in-scan microbench: T * 2 sequential [F, F] @ [F, N]
                   applications (M^T then M per frame, renormalised), the
                   M traffic the two scans pay, as one number
  fwd_only_ms      den.forward() (the alpha scan, no posteriors)
  fwd_bwd_ms       den.forward_backward()

  high     the loop scans with matmul_impl="plain": torch.matmul at
           "highest" precision
  pallas   the loop scans on the den_matmul kernel
  fused    the den_scan kernels (their in-scan microbench is den_matmul's)
  split3   revoked in the JAX package, not ported (ROADMAP.md queue 1
           item 5): the tool exits 2

One JSON line per impl, then the report.  The first line is the card's
name and power limit.  Runs on the card unless given --device (the CPU
runs the plain versions; its per-kernel lines hold CPU operator times).
`main(argv)` returns the report.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.ops import den_scan
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, den_graph, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.utils.profiling import (
    kernel_times, profile_fn, sync_device,
)

IMPLS = {"high": dict(matmul_impl="plain", scan_impl="loop"),
         "pallas": dict(matmul_impl="kernel", scan_impl="loop"),
         "fused": dict(scan_impl="fused")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--split", default="kernel", choices=["kernel", "pre"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impls", default="high,fused",
                    help="comma list: high | pallas (loop scans, plain or "
                         "den_matmul products) | fused (the den_scan "
                         "kernels); split3 is not ported")
    device_arg(ap, "the den")
    return ap.parse_args(argv)


def report(name, fn, dev):
    fn()                                  # built and warm
    sync_device(dev)
    _, rows = kernel_times(fn, dev)
    print(json.dumps({"call": name,
                      "device_us": sum(r[2] for r in rows),
                      "kernels": [{"name": k[:80], "launches": n,
                                   "us": us, "us_per_launch": us / n}
                                  for k, n, us in rows]}), flush=True)


def scan_matmuls(sk, v, T):
    """T forward + T backward sequential dense applications, as the scans
    pay them, renormalised so the values neither over- nor underflow."""
    for _ in range(T):
        v = sk._apply_M(v, transpose=True)
        v = sk._apply_M(v, transpose=False)
        v = v / torch.sum(torch.abs(v), dim=0, keepdim=True)
    return v


def kernel_profiles(graph, args, dev, gen):
    N, T, P = args.batch, args.frames, args.pdfs
    layout = analyze_chain_structure(graph)
    dm = DenMatmul(layout.M, dev, split=args.split)
    v = torch.rand((dm.F, N), generator=gen, device=dev)
    report("den_matmul", lambda: dm.apply(v, True), dev)

    sk = StructuredKernels(layout, 1e-5, scan_impl="fused", split=args.split,
                           device=dev)
    x = torch.exp(torch.randn((T, P, N), generator=gen, device=dev))
    xs = sk._hoisted_emissions(x)
    kw = dict(L=sk.lay.L, T=T, leaky=sk.leaky)
    fwd = den_scan.fused_forward(sk.M, *xs, sk.init, planes=sk._planes, **kw)
    total = fwd[3] * (1.0 + sk.leaky * sk._init_sum)
    report("den_scan_fwd", lambda: den_scan.fused_forward(
        sk.M, *xs, sk.init, planes=sk._planes, **kw), dev)
    report("den_scan_bwd", lambda: den_scan.fused_backward(
        sk.M, *xs, fwd[1], sk.init, sk.real, total, planes=sk._planes,
        **kw), dev)

    den = DenominatorComputation(graph, leaky=1e-5, split=args.split,
                                 device=dev)
    nnet = torch.randn((N, T, P), generator=gen, device=dev)
    report(f"den_forward_backward ({den._structured.scan_impl} scans)",
           lambda: den.forward_backward(nnet), dev)
    del den
    blocked = DenominatorComputation(graph, leaky=1e-5, layout="blocked",
                                     device=dev)
    report(f"den_forward_backward (blocked, {blocked.posterior_reduce} "
           f"posterior reduce)", lambda: blocked.forward_backward(nnet), dev)


def main(argv=None) -> dict:
    args = parse_args(argv)
    impls = args.impls.split(",")
    unknown = [i for i in impls if i not in IMPLS]
    if unknown:
        print(f"profile_den: --impls {','.join(unknown)} is not ported "
              f"(split3 was revoked in the JAX package, ROADMAP.md queue 1 "
              f"item 5); the impls are {', '.join(IMPLS)}", file=sys.stderr)
        raise SystemExit(2)
    dev = tool_device("profile_den", args.device)
    print(card_line(dev), flush=True)
    N, T, P = args.batch, args.frames, args.pdfs
    graph = den_graph("phone-lm", P)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_profiles(graph, args, dev, gen)

    rng = np.random.default_rng(0)
    out = torch.from_numpy(
        rng.normal(size=(N, T, P)).astype(np.float32) * 0.1).to(dev)

    def mean_ms(fn, *a):
        return profile_fn(fn, *a, iters=args.iters, warmup=1)["mean_ms"]

    result = {"config": {"B": N, "T": T, "P": P, "S": graph.num_states,
                         "A": graph.num_transitions}}
    for impl in impls:
        den = DenominatorComputation(graph, leaky=1e-5, split=args.split,
                                     device=dev, **IMPLS[impl])
        sk = den._structured
        v0 = torch.from_numpy(
            rng.normal(size=(sk.lay.F, N)).astype(np.float32)).to(dev)
        result[impl] = {
            "scan_matmuls_ms": mean_ms(scan_matmuls, sk, v0, T),
            "fwd_only_ms": mean_ms(den.forward, out),
            "fwd_bwd_ms": mean_ms(den.forward_backward, out),
            "scan_used": sk.scan_used,
        }
        print(json.dumps({impl: result[impl]}), flush=True)
        del den, sk
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
