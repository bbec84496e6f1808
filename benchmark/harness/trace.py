"""The traced part of a window: torch.profiler over a span of the run, read
back as kernel intervals.

`Tracer.start()` / `stop()` open and close the profiler around a span of
the window, synchronising the device at both ends, so the span's host
length is the traced window.  `summary()` exports the profiler's Chrome
trace to a temporary file, reads it and deletes it, and reduces it to:

- busy_s: the union of the device's kernel, memcpy and memset intervals;
- window_s: the span's length on the host clock;
- kernels: device seconds and launches by kernel name;
- breakdown: the 10 device operations that took most time, and the 10
  longest idle gaps of the device, each named by what the host was doing
  at the gap's middle: the innermost host operation open then, and the
  last one that had ended before it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def kernel_base(name: str) -> str:
    """A kernel's identifier without its return type, template arguments
    and parameter list ("void foo_kernel<6>(float*)" -> "foo_kernel")."""
    name = name.strip().replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def warm_up(self) -> None:
        """Open and close the profiler once, in set-up: its first start
        initialises the device tracer, which takes seconds."""
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self.prof = None

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return summarize(events, self.window_s)


def _union(intervals: np.ndarray) -> tuple:
    """(total covered length, merged [start, end] rows) of intervals."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged)
    return float(np.sum(m[:, 1] - m[:, 0])), m


def summarize(events: list, window_s: float) -> dict:
    dev, host = [], []
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            slot = by_name[kernel_base(e.get("name", "?"))]
            slot[0] += dur * 1e-6
            slot[1] += 1
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?")))
    busy_us, merged = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    gaps = []
    if len(merged) > 1:
        starts, ends = merged[1:, 0], merged[:-1, 1]
        lengths = starts - ends
        order = np.argsort(-lengths)[:10]
        hs = np.asarray([h[0] for h in host]) if host else np.zeros(0)
        he = np.asarray([h[1] for h in host]) if host else np.zeros(0)
        for i in order:
            mid = 0.5 * (ends[i] + starts[i])
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            inner = ("python" if len(cover) == 0 else
                     host[int(cover[np.argmin(he[cover] - hs[cover])])][2])
            done = np.nonzero(he < mid)[0]
            last = host[int(done[np.argmax(he[done])])][2] if len(done) \
                else "start"
            gaps.append([f"{inner}, after {last}", float(lengths[i]) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "kernels": {k: {"seconds": v[0], "launches": v[1]}
                        for k, v in by_name.items()},
            "breakdown": {"device_ops": [[k, v[0]] for k, v in top],
                          "idle_gaps": gaps}}
