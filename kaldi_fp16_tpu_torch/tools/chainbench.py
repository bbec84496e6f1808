"""chainbench on PyTorch: time the chain numerator and denominator
forward-backward at production scale.

The torch twin of tools/chainbench.py, with the same graphs and the same
JSON line (less `vs_baseline`, which divided by another card's number):

    python -m kaldi_fp16_tpu_torch.tools.chainbench [--topology phone-lm]
        [--layout auto|structured|blocked] [--scan-impl auto|loop|fused]
        [--matmul-impl auto|high|pallas]
        [--posterior-reduce auto|einsum|kernel] [--batch 8] [--frames 50]
        [--pdfs 3080] [--device cuda]

`--matmul-impl` maps the JAX tool's lowerings as tools.profile_den's
impls do: `high` is the loop scans with matmul_impl="plain" (torch.matmul
at "highest" precision), `pallas` the loop scans on the den_matmul
kernel, `auto` the port's default (the kernel, and the scans
--scan-impl names), `split3` the loop scans with every M product one
stacked bf16 product of the 3-term splits.  `--num-states` is
accepted and unused, as in the JAX tool.

On a card (`--device cuda`, the default) each fn is timed with CUDA events
over `--iters` back-to-back calls after one warm-up; the kernels are built
on first use.  `--device cpu` runs the plain versions and times them on
the host clock (`"timer": "host"` in the line): a CPU number is never a
device metric.  No card with `--device cuda` is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO, NumeratorGraphBatch
from kaldi_fp16_tpu_torch.chain.numerator import numerator_forward_backward
from kaldi_fp16_tpu_torch.tools._common import (
    DEN_ARCS, DEN_STATES, den_graph, time_ms,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=50)  # post-subsampling
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--den-states", type=int, default=DEN_STATES)
    ap.add_argument("--den-arcs", type=int, default=DEN_ARCS)
    ap.add_argument("--num-states", type=int, default=200,
                    help="accepted and unused, as in the JAX tool")
    ap.add_argument("--num-arcs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--topology", default="random",
                    choices=["random", "phone-lm"],
                    help="random = locality-free worst case; phone-lm = "
                         "realistic den.fst structure")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "structured", "blocked"])
    ap.add_argument("--scan-impl", default="auto",
                    choices=["auto", "loop", "fused"],
                    help="structured den scans: den_matmul per frame "
                         "(loop) or the fused scan kernels")
    ap.add_argument("--matmul-impl", default="auto",
                    choices=["auto", "split3", "high", "pallas"],
                    help="structured den matmul: high = loop scans with "
                         "torch.matmul, pallas = loop scans on the "
                         "den_matmul kernel, split3 = loop scans with the "
                         "stacked bf16 3-term split product, auto = the "
                         "port's default")
    ap.add_argument("--posterior-reduce", default="auto",
                    choices=["auto", "einsum", "kernel"],
                    help="blocked den per-pdf posterior reduce: one-hot "
                         "product or the segment_reduce kernel (auto: the "
                         "kernel on a card, the product on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def make_graph(args, rng):
    """tools/chainbench.py:60-86: the phone-LM den graph, or a uniformly
    random one at den.fst scale."""
    return den_graph(args.topology, args.pdfs, args.den_states,
                     args.den_arcs, rng)


def make_num_graph(B, T, P, num_arcs, rng):
    """tools/chainbench.py:90-104: a linear chain of exactly T arcs plus
    parallel alternative arcs up to num_arcs."""
    Sn, An = T + 1, max(num_arcs, T)
    return NumeratorGraphBatch(
        arc_src=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1), (B, 1)),
        arc_dst=np.tile(np.arange(An, dtype=np.int32) % (Sn - 1) + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)


def den_options(matmul_impl: str, scan_impl: str) -> dict:
    """--matmul-impl and --scan-impl -> the den's options: a JAX lowering
    name runs the loop scans, as in the JAX tool, and the den maps it to
    the port's route (den_structured.MATMUL_IMPLS); auto keeps the
    port's default den on the scans --scan-impl names."""
    if matmul_impl == "auto":
        return {"scan_impl": scan_impl}
    return {"matmul_impl": matmul_impl, "scan_impl": "loop"}


def main(argv=None):
    args = parse_args(argv)
    den_kw = den_options(args.matmul_impl, args.scan_impl)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chainbench: no CUDA device; pass --device cpu to "
                         "run the plain versions on the host")
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    B, T, P = args.batch, args.frames, args.pdfs
    graph = make_graph(args, rng)
    den = DenominatorComputation(graph, leaky=1e-5, layout=args.layout,
                                 posterior_reduce=args.posterior_reduce,
                                 device=dev, **den_kw)
    num_graph = make_num_graph(B, T, P, args.num_arcs, rng)
    out = torch.from_numpy(
        rng.normal(size=(B, T, P)).astype(np.float32) * 0.1).to(dev)

    results = {
        "den_fwd_bwd": time_ms(lambda: den.forward_backward(out),
                               args.iters, dev),
        "num_fwd_bwd": time_ms(lambda: numerator_forward_backward(num_graph,
                                                                  out),
                               args.iters, dev),
    }
    total = results["den_fwd_bwd"] + results["num_fwd_bwd"]
    structured = den._structured
    print(json.dumps({
        "metric": "chain_loss_ms_per_sequence",
        "value": total / B,
        "unit": "ms/seq",
        "detail": {**results, "batch_total_ms": total,
                   "den_layout": den.layout_used,
                   "matmul_impl": args.matmul_impl,
                   "matmul_route": (structured.matmul_impl if structured
                                    else None),
                   "scan_used": structured.scan_used if structured else None,
                   "posterior_reduce": (None if structured
                                        else den.posterior_reduce)},
        "config": {"B": B, "T": T, "P": P, "den_states": graph.num_states,
                   "den_arcs": graph.num_transitions},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "timer": "cuda_events" if dev.type == "cuda" else "host",
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
