"""What the verification and measurement tools share: the device they
check, the card's name line, a timer, the kernels' launch counts, the
bench tools' den graph, and the metrics file a killed training run
leaves behind."""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.device import resolve_device

DEN_STATES, DEN_ARCS = 7052, 113380     # den.fst's scale, the random graph's


def device_arg(ap, what="the checks"):
    """Add --device to an ArgumentParser."""
    ap.add_argument("--device", default=None,
                    help=f"torch device for {what} (default: the current "
                         f"CUDA device; with no card, pass --device cpu)")


def tool_device(name: str, device) -> torch.device:
    """--device as a torch.device; None is the current CUDA device.  A tool
    that checks the card never carries on on the CPU: with no card and no
    --device, it exits with a message."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{name}: {e}") from None


def card_line(device) -> str:
    """The cards' names and power limits as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or "cpu" for a CPU
    device: the first line a measurement tool prints."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters, dev):
    """Mean milliseconds per call after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def kernel_launches() -> dict:
    """The CUDA kernels' wrappers' launch counts, by kernel."""
    from kaldi_fp16_tpu_torch.ops import den_scan
    from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
    from kaldi_fp16_tpu_torch.ops.segment_reduce import segment_reduce
    return {"den_matmul": DenMatmul.launches,
            "den_matmul_pre": DenMatmul.launches_pre,
            "den_scan_fwd": den_scan.fused_forward.launches,
            "den_scan_bwd": den_scan.fused_backward.launches,
            "segment_reduce": segment_reduce.launches}


def den_graph(topology, P, S=DEN_STATES, A=DEN_ARCS, rng=None):
    """The den graph of the JAX bench tools (chainbench, trainbench,
    roofline): "phone-lm", the production phone-LM topology (scaled down
    below 3080 pdfs), or "random", S states and A arcs drawn from rng."""
    if topology == "phone-lm":
        kw = {} if P >= 3080 else dict(
            num_phones=max(2, P // 2), states_per_phone=2,
            branching=min(8, max(2, P // 4)))
        return DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=P,
                                                               **kw), P)
    dst = np.sort(rng.integers(0, S, size=A).astype(np.int32))
    return DenominatorGraph(
        src=rng.integers(0, S, size=A).astype(np.int32), dst=dst,
        pdf=rng.integers(0, P, size=A).astype(np.int32),
        prob=rng.uniform(0.1, 1.0, size=A).astype(np.float32),
        initial=(lambda v: v / v.sum())(
            rng.uniform(0, 1, S).astype(np.float32)),
        num_states=S, num_pdfs=P, start_state=0)


def read_metrics(path):
    """Rows of a metrics JSONL file; tolerates a torn tail line (a
    killed training run tears its last write)."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows
