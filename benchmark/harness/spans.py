"""Per-layer host times from the program's span registry
(kaldi_fp16_tpu_torch/utils/spans.py).

A reader's number is the median duration, in ms, of one span's
occurrences that started inside the window: from the start of the
window's first step to the end of its last, both read off the
`train_step` span, whose occurrences are one a step (set-up's steps,
then the record's `steps`, then its `traced_steps`).  So neither set-up
nor the traced steps, whose host side the profiler slows, count.  Where
the record does not place the window (fewer `train_step` occurrences
than it counts), every kept occurrence counts.

None where the span never ran, and where the program has no registry.
"""

from __future__ import annotations

import statistics
from typing import Optional


def registry() -> Optional[dict]:
    """The program's spans as `snapshot()` gives them, or None."""
    try:
        from kaldi_fp16_tpu_torch.utils import spans
    except ImportError:         # a program without the registry
        return None
    return spans.snapshot()


def window_ns(snap: dict, rec: dict) -> Optional[tuple]:
    """(start, end) of the window's steps on the spans' clock, or None."""
    steps = snap.get("train_step")
    n, traced = rec.get("steps") or 0, rec.get("traced_steps") or 0
    if not steps or n <= 0 or len(steps["ms"]) < n + traced:
        return None
    first = len(steps["ms"]) - n - traced
    last = first + n - 1
    return (steps["start_ns"][first],
            steps["start_ns"][last] + steps["ms"][last] * 1e6)


def median_ms(rec: dict, name: str) -> Optional[float]:
    snap = registry()
    if not snap or name not in snap or not snap[name]["ms"]:
        return None
    s = snap[name]
    win = window_ns(snap, rec)
    ms = [m for t, m in zip(s["start_ns"], s["ms"])
          if win is None or win[0] <= t <= win[1]]
    return statistics.median(ms) if ms else None
