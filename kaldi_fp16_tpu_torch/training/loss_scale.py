"""Dynamic loss scaling on PyTorch (port of kaldi_fp16_tpu/training/loss_scale.py).

Init 65536, growth x2 every 2000 good steps, backoff x0.5 on overflow
(ref: cpp/include/tensor_fp16.h LossScaler).  bf16 shares fp32's exponent
range, so scaling is rarely needed; it is kept for fp16-compute parity and
as a guard for pathological batches.  Gradients are nested dicts of
tensors ({layer: {name: tensor}}).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import torch

from kaldi_fp16_tpu_torch.device import resolve_device


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # current multiplier
    good_steps: torch.Tensor   # consecutive overflow-free steps
    growth_interval: torch.Tensor
    growth_factor: torch.Tensor
    backoff_factor: torch.Tensor
    min_scale: torch.Tensor
    max_scale: torch.Tensor


def init_loss_scale(initial: float = 65536.0, growth_interval: int = 2000,
                    growth_factor: float = 2.0, backoff_factor: float = 0.5,
                    min_scale: float = 1.0, max_scale: float = 2.0 ** 24,
                    device=None) -> LossScaleState:
    device = resolve_device(device)

    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return LossScaleState(
        scale=f(initial), good_steps=i(0), growth_interval=i(growth_interval),
        growth_factor=f(growth_factor), backoff_factor=f(backoff_factor),
        min_scale=f(min_scale), max_scale=f(max_scale))


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of the same structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def grads_finite(grads) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all()
                        for g in tree_leaves(grads)]).all()


def unscale_grads(grads, state: LossScaleState):
    inv = 1.0 / state.scale
    return tree_map(lambda g: g * inv, grads)


def update_loss_scale(state: LossScaleState, finite: torch.Tensor
                      ) -> Tuple[LossScaleState, torch.Tensor]:
    """Returns (new_state, skip_update): skip when grads overflowed."""
    good = torch.where(finite, state.good_steps + 1, 0).to(torch.int32)
    grow = good >= state.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow,
                    torch.minimum(state.scale * state.growth_factor,
                                  state.max_scale),
                    state.scale),
        torch.maximum(state.scale * state.backoff_factor, state.min_scale))
    new_good = torch.where(grow, 0, good).to(torch.int32)
    return state._replace(scale=new_scale, good_steps=new_good), ~finite
