"""Step timing on the host clock and, on a card, with CUDA events; the
kernels of one call by name under torch.profiler; a Chrome trace of a
block (`trace`); the latency of a call (`profile_fn`); the H100's peaks.

`trace` and `profile_fn` port kaldi_fp16_tpu/utils/profiling.py:21 and
:63.  `mxu_utilization` (:84) is not ported: it divides by the TPU v5e's
MXU peak.  The H100's peaks are `H100_PEAK_BF16_FLOPS` and
`H100_PEAK_HBM_BYTES` below, which chip_smoke's bounds and tools.roofline
read.

`StepTimer` ports kaldi_fp16_tpu/utils/profiling.py:32-61.  Over the timed
steps (the first `skip_first` left out) it reports:

  * the host time of each `with` block (`mean_ms`, `p50_ms`, `p95_ms`,
    `max_ms`, the JAX timer's keys): the time to enqueue a step, plus
    whatever the step waits for on the device;
  * `loop_mean_ms`: the host time from the first timed step's start to the
    last one's end, over the number of timed steps: the steps and what the
    loop around them (loading, uploads, logging, checkpoints) adds;
  * on a CUDA device, each step's device time from an event recorded on
    the current stream where its block starts to one recorded where it
    ends (`device_mean_ms`, ..., `device_each_ms`), and on the same clock
    and over the same steps the window from the first timed start event
    to the last end event (`device_window_ms`, `device_loop_mean_ms` per
    step), the gaps between one step's end and the next one's start
    (`device_gaps_ms`), and `idle_share`, 1 - (sum of the steps' device
    times) / window: the share of the window in which no step was open on
    the device's stream.  The spans of one stream do not overlap, so the
    window is the spans plus the gaps and the share is never negative.

`summary()` waits for the last event.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
H100_PEAK_BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
H100_PEAK_HBM_BYTES = 3.35e12          # HBM3 bytes per second


class StepTimer:
    """Step statistics with the first `skip_first` steps left out (the
    warm-up: the first call of each shape builds kernels and plans)."""

    def __init__(self, skip_first: int = 1, device=None):
        self.skip_first = skip_first
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._seen = 0
        self._t0: Optional[float] = None
        self._ev0 = None
        self._host: List[float] = []
        self._first_start: Optional[float] = None
        self._last_end: Optional[float] = None
        self._events: list = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self._cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._seen += 1
        if self._seen <= self.skip_first:
            return
        self._host.append(t1 - self._t0)
        if self._first_start is None:
            self._first_start = self._t0
        self._last_end = t1
        if self._cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            self._events.append((self._ev0, ev1))

    @staticmethod
    def _stats(prefix: str, a) -> dict:
        a = np.asarray(a)
        return {f"{prefix}mean_ms": float(a.mean() * 1000),
                f"{prefix}p50_ms": float(np.percentile(a, 50) * 1000),
                f"{prefix}p95_ms": float(np.percentile(a, 95) * 1000),
                f"{prefix}max_ms": float(a.max() * 1000)}

    def summary(self) -> dict:
        if not self._host:
            return {"steps": 0}
        n = len(self._host)
        out = {"steps": n, **self._stats("", self._host),
               "loop_mean_ms": (self._last_end - self._first_start) / n * 1000}
        if self._events:
            ev = self._events
            ev[-1][1].synchronize()
            dev = [a.elapsed_time(b) for a, b in ev]            # ms
            window = ev[0][0].elapsed_time(ev[-1][1])
            out.update(self._stats("device_", np.asarray(dev) / 1000))
            out["device_each_ms"] = dev
            out["device_window_ms"] = window
            out["device_loop_mean_ms"] = window / n
            out["device_gaps_ms"] = [ev[i][1].elapsed_time(ev[i + 1][0])
                                     for i in range(n - 1)]
            out["idle_share"] = 1.0 - sum(dev) / window
        return out


def kernel_times(fn, device=None):
    """(wall ms, [(kernel name, launches, us)]) of one call of fn under
    torch.profiler, largest first: each kernel's device time on a card,
    each operator's own CPU time otherwise.  The profiler's cost per
    launch is in the wall time."""
    cuda = device is None or torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count,
             e.device_time_total if cuda else e.self_cpu_time_total)
            for e in prof.key_averages()]
    return wall, sorted([r for r in rows if r[2] > 0], key=lambda r: -r[2])


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block with torch.profiler (the host's activity and, with
    a CUDA device, the card's) and write its Chrome trace to
    logdir/trace.json; yields the profiler.  `device` None: the card when
    there is one."""
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def sync_device(device) -> None:
    """Wait for the card's queued work; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sync(out) -> None:
    """Wait for the devices of the tensors in `out` (nested tuples, lists
    and dicts); nothing for CPU tensors."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(out)
    for d in devices:
        sync_device(d)


def profile_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> dict:
    """Time fn(*args) after warm-up on the host clock, each call ended by a
    sync of its outputs' devices: {mean_ms, p50_ms, min_ms}."""
    out = fn(*args)
    for _ in range(max(0, warmup - 1)):
        out = fn(*args)
    _sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    a = np.asarray(times)
    return {"mean_ms": float(a.mean() * 1000),
            "p50_ms": float(np.percentile(a, 50) * 1000),
            "min_ms": float(a.min() * 1000)}


class PhaseClock:
    """Wall seconds per phase of a call that marks where each phase ends
    (e.g. DeviceLatticeDecoder.decode_batch's `mark`): each mark syncs the
    device, so a phase's time is its work's, and the phases sum to the
    call from `start()` to the last mark."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict = {}
        self._last = None

    def start(self) -> "PhaseClock":
        sync_device(self.device)
        self.seconds = {}
        self._last = time.perf_counter()
        return self

    def __call__(self, name: str) -> None:
        sync_device(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._last
        self._last = now
