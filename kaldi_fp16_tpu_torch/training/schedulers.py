"""Learning-rate schedules (step -> lr): copies of the schedules of
kaldi_fp16_tpu/training/schedulers.py (:13-35), plain Python.  Adam, the
rest of that module, is not ported yet."""

from __future__ import annotations

from typing import Callable


def step_lr(initial: float, step_size: int, gamma: float = 0.1
            ) -> Callable[[int], float]:
    def lr(step: int) -> float:
        return initial * (gamma ** (step // step_size))
    return lr


def exponential_decay_lr(initial: float, gamma: float) -> Callable[[int], float]:
    def lr(step: int) -> float:
        return initial * (gamma ** step)
    return lr


def warmup_lr(base: Callable[[int], float], warmup_steps: int
              ) -> Callable[[int], float]:
    """Linear warmup from 0 over warmup_steps, then the base schedule."""
    def lr(step: int) -> float:
        if step < warmup_steps:
            return base(warmup_steps) * (step + 1) / warmup_steps
        return base(step)
    return lr
