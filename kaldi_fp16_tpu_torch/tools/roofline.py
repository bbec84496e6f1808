"""roofline on PyTorch: speed-of-light analysis of the training
pipeline's stages on the card.

The twin of tools/roofline.py.  For each stage it measures the time on
the card (CUDA events over --iters calls after one warm-up), counts the
stage's operations and bytes, and reports the achieved TFLOP/s and GB/s
as shares of the card's peaks, with the implied bound (compute or
memory).  Stages: the flagship forward (bf16 compute, eval BatchNorm),
forward + parameter gradients, the den forward-backward (production
den.fst scale, T_out = 49), the numerator forward-backward, one full
train step (bench.py's: SGD with momentum).

XLA's cost analysis has no torch counterpart, so the counts are:

  * operations: the products (matmuls, convolutions) torch runs, as
    torch.utils.flop_counter.FlopCounterMode counts them, plus the work of
    the hand-written CUDA kernels, which it cannot see, counted per launch
    as the algorithm needs it, the count of benchmark/counts/den_scan.py
    `scan_work`: T * (2 * F^2 * N + 4 * L * F * N) for a den_scan call
    and 2 * F^2 * N for a den_matmul application, F the real chains and
    N the real sequences (the kernels' bf16 splits and the padding of
    chains and rows are the implementation's and are not counted);
    segment_reduce and every elementwise op or reduction count none;
  * bytes: each input, parameter and output of the stage read or written
    once (fp32 masters and the den's [F, F] matrix included; a train
    step reads and writes its parameters and velocities), nothing for
    the intermediates.

The peaks default to one H100 SXM's (989 TFLOP/s dense bf16, 3.35 TB/s,
utils/profiling.py), at the card's power limit (the first line).  A share
over 100 % means the count is wrong: the tool prints a FAIL line for it
and exits 1.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.roofline [--batch 128]
      [--frames 150] [--peak-tflops 989] [--peak-gbs 3350]
      [--stages fwd,bwd,den,num,step] [--topology phone-lm|random]
      [--xconfig configs/cnn_tdnn.xconfig] [--device cpu]

`--device cpu` counts the same and times the plain versions on the host
clock (`"timer": "host"`): its shares are not the card's.  `main(argv)`
returns {"rows": [...], "failures": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO, NumeratorGraphBatch
from kaldi_fp16_tpu_torch.chain.numerator import numerator_forward_backward
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.ops import den_scan
from kaldi_fp16_tpu_torch.ops import segment_reduce as segment_reduce_ops
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, den_graph, device_arg, time_ms, tool_device,
)
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from kaldi_fp16_tpu_torch.utils.profiling import (
    H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BYTES, sync_device,
)

ROOT = Path(__file__).resolve().parents[2]
T_OUT_DEN = 49           # the den / num stages' frames (tools/roofline.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--peak-tflops", type=float,
                    default=H100_PEAK_BF16_FLOPS / 1e12,
                    help="dense bf16 tensor-core peak (H100 SXM)")
    ap.add_argument("--peak-gbs", type=float,
                    default=H100_PEAK_HBM_BYTES / 1e9,
                    help="HBM bandwidth peak (H100 SXM)")
    ap.add_argument("--stages", default="fwd,bwd,den,num,step")
    ap.add_argument("--topology", choices=["phone-lm", "random"],
                    default="phone-lm",
                    help="phone-lm: the production den class (the "
                         "structured den); random: the blocked den")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--xconfig", default=str(ROOT / "configs" /
                                             "cnn_tdnn.xconfig"))
    device_arg(ap, "the stages")
    return ap.parse_args(argv)


def kernel_launches() -> dict:
    return {"den_matmul": DenMatmul.launches + DenMatmul.launches_pre,
            "den_scan": (den_scan.fused_forward.launches
                         + den_scan.fused_backward.launches),
            "segment_reduce": segment_reduce_ops.segment_reduce.launches}


def kernel_flops(launches: dict, den, N: int, T: int) -> float:
    """The work of the kernels' launches, which FlopCounterMode does not
    see, over N sequences of T frames (the module docstring's count)."""
    sk = den._structured
    if sk is None:
        return 0.0
    L = sk.lay.L
    F = int(np.count_nonzero(sk.lay.real.any(axis=0)))   # the real chains
    product = 2.0 * F * F * N
    return (launches["den_scan"] * T * (product + 4.0 * L * F * N)
            + launches["den_matmul"] * product)


def count(fn, dev, den=None, N=0, T=0):
    """(operations, the kernels' launches) of one call of fn."""
    before = kernel_launches()
    with FlopCounterMode(display=False) as fc:
        fn()
        sync_device(dev)
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    flops = float(fc.get_total_flops())
    if den is not None:
        flops += kernel_flops(launches, den, N, T)
    return flops, launches


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def report(name, seconds, flops, bytes_, peak_tflops, peak_gbs, launches):
    tflops = flops / seconds / 1e12 if seconds else 0.0
    gbs = bytes_ / seconds / 1e9 if seconds else 0.0
    pct_c = 100.0 * tflops / peak_tflops
    pct_m = 100.0 * gbs / peak_gbs
    return {
        "stage": name, "ms": seconds * 1e3, "gflop": flops / 1e9,
        "tflops": tflops, "pct_peak_compute": pct_c,
        "gbs": gbs, "pct_peak_bw": pct_m,
        "bound": "compute" if pct_c >= pct_m else "memory",
        "bytes": bytes_, "launches": launches,
    }


def num_graph(B, An, P, rng):
    """tools/roofline.py's numerator: a chain of An // 2 + 1 states with
    An arcs (two per hop), reachable final."""
    Sn = An // 2 + 2
    arcs = np.arange(An, dtype=np.int32) % (Sn - 1)
    return NumeratorGraphBatch(
        arc_src=np.tile(arcs, (B, 1)), arc_dst=np.tile(arcs + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)


def graph_bytes(g: NumeratorGraphBatch) -> int:
    return sum(np.asarray(getattr(g, k)).nbytes for k in (
        "arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask", "start",
        "final_logw"))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("roofline", args.device)
    print(card_line(dev), flush=True)
    stages = set(args.stages.split(","))
    rng = np.random.default_rng(0)
    B, T, P = args.batch, args.frames, args.pdfs
    model = build_model(args.xconfig)
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=3, left_context=3)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, dev)
    feats = torch.from_numpy(rng.normal(size=(B, T, 40))
                             .astype(np.float32)).to(dev)
    ivecs = torch.from_numpy(rng.normal(size=(B, 100))
                             .astype(np.float32)).to(dev)
    params = [w for p in net.params.values() for w in p.values()]
    p_bytes = nbytes(*params)
    peaks = (args.peak_tflops, args.peak_gbs)
    rows = []

    def fwd_loss():
        outs, _ = net(feats, ivecs, train=False,
                      compute_dtype=torch.bfloat16)
        return outs["output"].float().sum(), outs

    if "fwd" in stages:
        with torch.no_grad():
            fl, n = count(fwd_loss, dev)
            outs = fwd_loss()[1]
            sec = time_ms(fwd_loss, args.iters, dev) / 1e3
        by = p_bytes + nbytes(feats, ivecs, *outs.values())
        rows.append(report("forward", sec, fl, by, *peaks, n))
        del outs

    if "bwd" in stages:
        def grad():
            # the xent head has no path to the chain output: zeros, as
            # jax.grad gives
            return torch.autograd.grad(fwd_loss()[0], params,
                                       allow_unused=True,
                                       materialize_grads=True)
        fl, n = count(grad, dev)
        sec = time_ms(grad, args.iters, dev) / 1e3
        rows.append(report("forward+grad", sec, fl,
                           2 * p_bytes + nbytes(feats, ivecs), *peaks, n))

    T_out = T_OUT_DEN
    An = 256
    if stages & {"den", "num", "step"}:
        den = DenominatorComputation(
            den_graph(args.topology, P, rng=rng), leaky=1e-5, device=dev)
        x_out = torch.from_numpy(
            rng.normal(size=(B, T_out, P)).astype(np.float32) * 0.1).to(dev)
        m_bytes = (nbytes(den._structured.M) if den._structured is not None
                   else 0)

    if "den" in stages:
        def den_fb():
            return den.forward_backward(x_out)
        fl, n = count(den_fb, dev, den, B, T_out)
        sec = time_ms(den_fb, args.iters, dev) / 1e3
        rows.append(report("den fwd-bwd", sec, fl,
                           2 * nbytes(x_out) + m_bytes, *peaks, n))

    if "num" in stages:
        g = num_graph(B, An, P, rng)

        def num_fb():
            return numerator_forward_backward(g, x_out)
        fl, n = count(num_fb, dev)
        sec = time_ms(num_fb, args.iters, dev) / 1e3
        rows.append(report("num fwd-bwd", sec, fl,
                           2 * nbytes(x_out) + graph_bytes(g), *peaks, n))

    if "step" in stages:
        g = num_graph(B, An, P, rng)
        n_out = (T - 3 + 2) // 3
        step = make_train_step(model, net, den, g, ChainTrainingOpts(),
                               config, num_frames_out=n_out)
        batch = {"features": feats, "ivectors": ivecs,
                 "weights": torch.ones(B, device=dev)}
        state = [opt, scale]

        def run():
            state[0], state[1], _ = step(state[0], state[1], batch)
        fl, n = count(run, dev, den, B, n_out)
        sec = time_ms(run, args.iters, dev) / 1e3
        # parameters and velocities read and written, the batch read
        by = 4 * p_bytes + nbytes(feats, ivecs) + graph_bytes(g) + m_bytes
        rows.append(report("train step", sec, fl, by, *peaks, n))

    failures = []
    for r in rows:
        print(json.dumps(r), flush=True)
        if r["pct_peak_compute"] > 100.0 or r["pct_peak_bw"] > 100.0:
            failures.append(r["stage"])
            print(f"FAIL {r['stage']}: {r['pct_peak_compute']:.1f} % of the "
                  f"compute peak, {r['pct_peak_bw']:.1f} % of the memory "
                  f"peak: the count is wrong", flush=True)
    print(json.dumps({"metric": "roofline", "timer": (
        "cuda_events" if dev.type == "cuda" else "host"),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "failures": failures}), flush=True)
    return {"rows": rows, "failures": failures}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
