"""Data-parallel training over a `DataGroup`: each rank's rows of the
batch, and the step's global reductions as explicit collectives.

Port of kaldi_fp16_tpu/parallel/data_parallel.py for the `data` axis
(`shard_batch` :89).  The JAX package jits the whole step with its
inputs sharded over `data` and lets GSPMD make every reduction global
(:1-14, :90-127); its docstring warns that per-shard BatchNorm statistics
"would silently switch" the result.  A rank here sees only its rows, so
the step reduces, each in an all-reduce of one flat buffer:

  * BatchNorm: the ranks' means, then their variances and the means'
    spread (`batch_moments`, two all-reduces per BN in the forward and
    two in the backward: the reductions are differentiable);
  * the gradients with the step's reported sums and the non-finite count
    (`all_reduce_grads`: one bucket, the parameters in a fixed order);
  * NG-SGD's sample sums and counts (training/natural_gradient.py).

Every rank then holds the same bits and runs the same update, so the
parameters stay bit-identical across ranks.  `broadcast_train_state`
makes them start so.  `param_shardings` (the `model` axis) is not
ported (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from kaldi_fp16_tpu_torch.parallel.mesh import DataGroup


def _rows(x, group: DataGroup):
    b = x.shape[0]
    if b % group.world:
        raise ValueError(f"batch {b} not divisible by the data group's "
                         f"{group.world} ranks")
    n = b // group.world
    return x[group.rank * n:(group.rank + 1) * n]


def shard_batch(batch: Dict, group: DataGroup) -> Dict:
    """This rank's rows of each array of `batch` (leading axis: the
    sequences); the rows are contiguous, rank 0 first."""
    return {k: _rows(v, group) for k, v in batch.items()}


def shard_graph(g, group: DataGroup):
    """This rank's rows of a NumeratorGraphBatch (chain/graph.py); the
    padded sizes stay the global batch's."""
    return dataclasses.replace(g, **{
        f.name: _rows(getattr(g, f.name), group)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), np.ndarray)})


def shard_chain_batch(batch, group: DataGroup):
    """This rank's rows of a ChainBatch (io/batch.py), its numerator
    graphs included."""
    graph = shard_graph(batch.num_graph, group)
    keys = np.asarray(batch.keys, dtype=object)
    return dataclasses.replace(
        batch, features=_rows(batch.features, group),
        ivectors=(None if batch.ivectors is None
                  else _rows(batch.ivectors, group)),
        weights=_rows(np.asarray(batch.weights), group),
        deriv_weights=(None if batch.deriv_weights is None
                       else _rows(batch.deriv_weights, group)),
        num_graph=graph, keys=list(_rows(keys, group)))


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group: DataGroup) -> List[torch.Tensor]:
    """The sums over the ranks of `tensors` (one dtype), through one
    all-reduce of a flat buffer; new tensors of the same shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    group.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


class _SumOverRanks(torch.autograd.Function):
    """y = the sum over the ranks of x; the gradient of each rank's x is
    the sum over the ranks of y's gradient (each rank's loss depends on
    every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


def batch_moments(x: torch.Tensor, group: DataGroup
                  ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean, biased variance, count) over the (batch, time) rows of every
    rank's x [B, T, D] (fp32), differentiable.  Every rank holds rows of
    one shape (the global batch split evenly, as the JAX package shards
    its arrays), so the count is `world` times this rank's and each rank's
    moments weigh 1 / world.  One all-reduce of the ranks' means gives the
    mean; one of their variances plus their means' squared distances from
    it gives the variance (the parallel-variance merge: no E[x^2] -
    E[x]^2 cancellation).  At world 1 both are torch.mean's and
    torch.var's bits, those of the single-process BatchNorm."""
    w = 1.0 / group.world
    local_mean = x.mean(dim=(0, 1))
    local_var = torch.clamp(x.var(dim=(0, 1), unbiased=False), min=0.0)
    mean = _SumOverRanks.apply(local_mean * w, group)
    var = _SumOverRanks.apply((local_var + (local_mean - mean) ** 2) * w,
                              group)
    return mean, var, float(x.shape[0] * x.shape[1] * group.world)


def spec_rows(masks, group: DataGroup):
    """This rank's rows of SpecAugment masks drawn for the global batch."""
    return tuple(None if m is None else _rows(m, group) for m in masks)


_ALIGN = 128     # fp32 elements: 512 bytes, the CUDA caching allocator's


def all_reduce_grads(grads: Dict, stats: Sequence[torch.Tensor],
                     group: DataGroup):
    """Sum the gradients (nested dicts of fp32 tensors, in their insertion
    order: the parameters' fixed order) and the scalars `stats` over the
    ranks, with the count of non-finite gradient entries, in one
    all-reduce.  Each gradient starts 512 bytes into the buffer past the
    last, so its view is aligned as a tensor of its own would be: kernels
    that read it (norms, NG's products) then take the single process's
    paths, and world 1 keeps its bits.  Returns (grads, stats
    [len(stats)], non-finite count)."""
    leaves: List[Tuple[dict, str]] = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append((tree, k))

    out = {l: dict(p) for l, p in grads.items()}
    walk(out)
    parts, starts, i = [], [], 0
    for d, k in leaves:
        g = d[k].reshape(-1).float()
        pad = -g.numel() % _ALIGN
        parts += [g, g.new_zeros(pad)] if pad else [g]
        starts.append(i)
        i += g.numel() + pad
    flat = torch.cat(parts)
    tail = torch.stack([s.float() for s in stats]
                       + [(~torch.isfinite(flat)).sum().float()])
    flat = group.all_reduce(torch.cat([flat, tail]))
    for (d, k), j in zip(leaves, starts):
        d[k] = flat[j:j + d[k].numel()].view(d[k].shape)
    return out, flat[i:-1], flat[-1]


def broadcast_train_state(net, opt_state, scale_state,
                          group: DataGroup) -> None:
    """Rank 0's parameters, BN statistics, optimizer and loss-scale states
    onto every rank, in place."""
    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
        elif hasattr(tree, "_asdict"):
            yield from tensors(tree._asdict())
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from tensors(v)

    with torch.no_grad():
        for t in list(net.state_dict().values()) + list(
                tensors(opt_state)) + list(tensors(scale_state)):
            group.broadcast(t)
