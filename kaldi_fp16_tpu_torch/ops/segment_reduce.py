"""Blocked segment sum for the blocked denominator's posterior pass.

The port of kaldi_fp16_tpu/ops/pallas_reduce.py (`blocked_segment_reduce`):

    out[b, s, n] = sum over k with labels[b, k] == s of vals[b, k, n]

for vals [NB, K, n] fp32 and labels [NB, K] int32 local keys; a label
outside [0, sb) is a padding slot and contributes nothing.  Exact mode
only: the JAX `exact=False` (single-pass bf16) is rejected.

`segment_reduce` launches the hand-written CUDA kernel
(csrc/segment_reduce.cu: an order pass, then a segmented row sum) for CUDA
tensors; for CPU tensors it computes the plain version,
`segment_reduce_plain`, which the tests compare against.  `segment_order`
runs the kernel's order pass alone (a stable counting sort of each block's
labels), beside its plain version `segment_order_plain`.  A CUDA tensor
never falls back to a plain version: if the kernel cannot be built or
launched, the call raises.  `segment_reduce.launches` and
`segment_order.launches` count calls that launched the kernel (one per
call, however many launches the C entry point makes).
"""

from __future__ import annotations

import torch

from kaldi_fp16_tpu_torch.ops._build import launch


def segment_reduce_plain(vals: torch.Tensor, labels: torch.Tensor,
                         sb: int = 128) -> torch.Tensor:
    """The plain version: an index_add_ of every slot into its block's row,
    with one extra row per block that collects the padding slots."""
    NB, K, n = vals.shape
    key = labels.to(torch.int64)
    key = torch.where((key >= 0) & (key < sb), key, sb)
    rows = (torch.arange(NB, device=vals.device)[:, None] * (sb + 1)
            + key).reshape(-1)
    out = torch.zeros((NB * (sb + 1), n), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, rows, vals.reshape(NB * K, n))
    return out.reshape(NB, sb + 1, n)[:, :sb]


def segment_order_plain(labels: torch.Tensor, sb: int = 128):
    """The order pass in plain PyTorch: labels [NB, K] int32 ->
    (order [NB, K] int32, offsets [NB, sb + 1] int32).  order[b, :offsets[b,
    sb]] holds the slots of labels in [0, sb) grouped by label, in
    increasing k within a group, segment s at offsets[b, s] .. offsets[b, s
    + 1]; the padding slots follow in k order (the kernel leaves that tail
    unwritten)."""
    NB, K = labels.shape
    key = labels.to(torch.int64)
    key = torch.where((key >= 0) & (key < sb), key, sb)
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((NB, sb + 1), dtype=torch.int64,
                         device=labels.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros((NB, sb + 1), dtype=torch.int64,
                          device=labels.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :sb], dim=1)
    return order, offsets.to(torch.int32)


def segment_order(labels: torch.Tensor, sb: int = 128):
    """The kernel's order pass alone: labels [NB, K] int32 -> (order [NB,
    K], offsets [NB, sb + 1]) int32, as `segment_order_plain` except that on
    a card order past offsets[b, sb] is left unwritten."""
    if labels.ndim != 2 or labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32 [NB, K], got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    if sb < 1:
        raise ValueError(f"sb must be >= 1, got {sb}")
    if labels.device.type == "cpu":
        return segment_order_plain(labels, sb)
    if labels.device.type != "cuda":
        raise ValueError(f"no segment_order kernel for {labels.device}")
    if not labels.is_contiguous():
        raise ValueError("labels must be contiguous")
    NB, K = labels.shape
    order = torch.empty((NB, K), dtype=torch.int32, device=labels.device)
    offsets = torch.empty((NB, sb + 1), dtype=torch.int32,
                          device=labels.device)
    if NB == 0:
        return order, offsets
    launch("segment_order", labels.device, labels, order, offsets, NB, K, sb)
    segment_order.launches += 1
    return order, offsets


def segment_reduce(vals: torch.Tensor, labels: torch.Tensor, sb: int = 128,
                   exact: bool = True) -> torch.Tensor:
    """vals [NB, K, n] f32, labels [NB, K] int32 (>= sb = padding)
    -> [NB, sb, n] f32 per-block segment sums."""
    if not exact:
        raise ValueError("segment_reduce is exact-only (fp32 sums); the "
                         "single-pass bf16 mode is not ported")
    if vals.ndim != 3 or vals.dtype != torch.float32:
        raise ValueError(f"vals must be float32 [NB, K, n], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != vals.shape[:2]:
        raise ValueError(f"labels must be int32 {tuple(vals.shape[:2])}, got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if labels.device != vals.device:
        raise ValueError(f"labels on {labels.device}, vals on {vals.device}")
    if sb < 1:
        raise ValueError(f"sb must be >= 1, got {sb}")
    dev = vals.device
    if dev.type == "cpu":
        return segment_reduce_plain(vals, labels, sb)
    if dev.type != "cuda":
        raise ValueError(f"no segment_reduce kernel for {dev}")
    if not (vals.is_contiguous() and labels.is_contiguous()):
        raise ValueError("vals and labels must be contiguous")
    NB, K, n = vals.shape
    out = torch.empty((NB, sb, n), dtype=torch.float32, device=dev)
    if n == 0 or NB == 0:
        return out
    order = torch.empty((NB, K), dtype=torch.int32, device=dev)
    offsets = torch.empty((NB, sb + 1), dtype=torch.int32, device=dev)
    launch("segment_reduce", dev, vals, labels, order, offsets, out, NB, K, n,
           sb)
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
segment_order.launches = 0
