"""Learning-rate schedules (step -> lr) and Adam: copies of
kaldi_fp16_tpu/training/schedulers.py, the schedules (:13-35) in plain
Python and Adam (:40-77) as plain tensor arithmetic in the JAX order.

Adam is written out rather than taken from torch.optim: `Adam`'s
weight_decay adds L2 to the gradient (another function than the JAX
package's decoupled decay) and `AdamW` rounds in another order."""

from __future__ import annotations

from typing import Callable

import torch

from kaldi_fp16_tpu_torch.training.loss_scale import tree_leaves, tree_map


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


# -- Adam (fp32 master-state) ------------------------------------------------

def init_adam_state(params) -> dict:
    """fp32 first and second moments shaped like `params` (a nested dict
    of tensors) and an int32 step count, on the parameters' device."""
    def zeros(w):
        return torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    dev = next(iter(tree_leaves(params))).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_update(params, grads, state, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """Standard Adam with optional decoupled weight decay.  Writes the new
    values into the parameter tensors (under no_grad, so nn.Parameters stay
    the same objects) and returns (params, new state), as the JAX function
    returns (new params, new state)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(w, g, m, v):
        g = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = lr * mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + lr * weight_decay * w.detach()
        with torch.no_grad():
            w.copy_(w - delta)
        return m2, v2

    moments = tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": tree_map(lambda mv: mv[0], moments),
                    "v": tree_map(lambda mv: mv[1], moments), "step": step}
