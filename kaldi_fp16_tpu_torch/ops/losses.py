"""Generic training losses: the torch twins of kaldi_fp16_tpu/ops/losses.py
(`cross_entropy`, `mse`), for the auxiliary model families (the x-vector
speaker classifier).  The chain pipeline has its own objective
(chain/objective.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy.  logits [..., C]; labels [...] int or
    [..., C] one-hot/soft; optional per-example weights [...]."""
    logp = torch.log_softmax(logits, dim=-1)
    c = logits.shape[-1]
    if labels.dim() == logits.dim() - 1:
        onehot = F.one_hot(labels.long(), c).to(logp.dtype)
    else:
        onehot = labels.to(logp.dtype)
    if label_smoothing:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / c
    nll = -(onehot * logp).sum(dim=-1)
    if weights is not None:
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1e-8)
    return nll.mean()


def mse(pred: torch.Tensor, target: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; optional per-example weights on axis 0."""
    se = (pred - target) ** 2
    if pred.dim() > 1:
        se = se.mean(dim=tuple(range(1, pred.dim())))
    if weights is not None:
        return (se * weights).sum() / torch.clamp(weights.sum(), min=1e-8)
    return se.mean()
