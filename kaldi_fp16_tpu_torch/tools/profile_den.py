"""Where the den's device time goes: per-kernel times under torch.profiler.

    python -m kaldi_fp16_tpu_torch.tools.profile_den [--batch 128]
        [--frames 49] [--pdfs 3080] [--split kernel|pre]

On one card, at bench.py's den geometry (the 7052-state phone-LM graph,
F = 3526 chains, N = --batch sequences, T = --frames), it profiles one
call of each: a den_matmul application (M^T @ v, n = N), a fused forward
scan, a fused backward scan, the default den's forward-backward, and the
same graph's forward-backward forced to the blocked layout (its default
posterior reduce: the segment_reduce kernel on a card), and prints one
JSON line per call with the device microseconds of every
kernel by name (total and per launch), sorted by total.  The first line
is the card's name and power limit as nvidia-smi gives them.  Each call
runs once unprofiled first, so the kernels are built and warm.

Needs a card: without one it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.ops import den_scan
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.utils.profiling import kernel_times


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--split", default="kernel", choices=["kernel", "pre"])
    return ap.parse_args(argv)


def report(name, fn):
    fn()                                  # built and warm
    torch.cuda.synchronize()
    _, rows = kernel_times(fn)
    print(json.dumps({"call": name,
                      "device_us": sum(r[2] for r in rows),
                      "kernels": [{"name": k[:80], "launches": n,
                                   "us": us, "us_per_launch": us / n}
                                  for k, n, us in rows]}), flush=True)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_den: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    N, T, P = args.batch, args.frames, args.pdfs
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=P), P)
    gen = torch.Generator(device=dev).manual_seed(0)

    layout = analyze_chain_structure(graph)
    dm = DenMatmul(layout.M, dev, split=args.split)
    v = torch.rand((dm.F, N), generator=gen, device=dev)
    report("den_matmul", lambda: dm.apply(v, True))

    sk = StructuredKernels(layout, 1e-5, scan_impl="fused", split=args.split,
                           device=dev)
    x = torch.exp(torch.randn((T, P, N), generator=gen, device=dev))
    xs = sk._hoisted_emissions(x)
    kw = dict(L=sk.lay.L, T=T, leaky=sk.leaky)
    fwd = den_scan.fused_forward(sk.M, *xs, sk.init, planes=sk._planes, **kw)
    total = fwd[3] * (1.0 + sk.leaky * sk._init_sum)
    report("den_scan_fwd", lambda: den_scan.fused_forward(
        sk.M, *xs, sk.init, planes=sk._planes, **kw))
    report("den_scan_bwd", lambda: den_scan.fused_backward(
        sk.M, *xs, fwd[1], sk.init, sk.real, total, planes=sk._planes, **kw))

    den = DenominatorComputation(graph, leaky=1e-5, split=args.split,
                                 device=dev)
    nnet = torch.randn((N, T, P), generator=gen, device=dev)
    report(f"den_forward_backward ({den._structured.scan_impl} scans)",
           lambda: den.forward_backward(nnet))
    del den
    blocked = DenominatorComputation(graph, leaky=1e-5, layout="blocked",
                                     device=dev)
    report(f"den_forward_backward (blocked, {blocked.posterior_reduce} "
           f"posterior reduce)", lambda: blocked.forward_backward(nnet))
    return 0


if __name__ == "__main__":
    sys.exit(main())
