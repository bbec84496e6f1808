"""X-vector speaker-embedding models on PyTorch.

Port of kaldi_fp16_tpu/models/xvector.py: frame-level TDNN layers with
spliced temporal contexts -> statistics pooling (mean + stddev over time)
-> segment-level affines; the first segment affine's pre-activation is
the x-vector embedding (Snyder et al. 2018).  Parameters are a nested
dict {layer: {"w": [in, out], "b": [out]}} of fp32 tensors, the JAX
package's tree and layout (convert.py moves them across unchanged).

The frame layers' products follow `jnp.dot(..., preferred_element_type=
jnp.float32)`: operands rounded to the compute dtype, then multiplied in
fp32 with fp32 accumulation (a bf16 torch.matmul would round its result
to bf16).  On a card that product must not run in TF32: torch's default,
`torch.backends.cuda.matmul.allow_tf32 = False`, must stand.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.ops.losses import cross_entropy
from kaldi_fp16_tpu_torch.ops.nn import stats_pooling


@dataclass(frozen=True)
class XVectorConfig:
    """Standard Kaldi x-vector recipe shape (5 TDNN + 2 segment layers)."""
    feat_dim: int = 30
    tdnn_dims: Tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_contexts: Tuple[Tuple[int, ...], ...] = (
        (-2, -1, 0, 1, 2), (-2, 0, 2), (-3, 0, 3), (0,), (0,))
    embed_dim: int = 512
    segment_dims: Tuple[int, ...] = (512, 512)
    num_speakers: int = 0          # 0 = no classifier head


def init_xvector(cfg: XVectorConfig, generator: torch.Generator,
                 device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Xavier-normal weights from `generator`, zero biases, on `device`
    (default: the current CUDA device), each a leaf that requires grad."""
    device = resolve_device(device)

    def layer(fan_in, fan_out):
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return {"w": (w * scale).to(device).requires_grad_(),
                "b": torch.zeros(fan_out, device=device).requires_grad_()}

    params = {}
    dim = cfg.feat_dim
    for i, (out, ctx) in enumerate(zip(cfg.tdnn_dims, cfg.tdnn_contexts)):
        params[f"tdnn{i}"] = layer(dim * len(ctx), out)
        dim = out
    dim = 2 * dim  # stats pooling: mean + stddev
    for i, out in enumerate(cfg.segment_dims):
        params[f"segment{i}"] = layer(dim, out)
        dim = out
    if cfg.num_speakers:
        params["output"] = layer(dim, cfg.num_speakers)
    return params


def _splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Concat time-shifted copies, clamped at the edges, along features."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[:, torch.clamp(t + o, 0, T - 1)] for o in offsets],
                     dim=-1)


def _dot(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w with both operands rounded to `dtype`, the product in fp32."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def xvector_forward(cfg: XVectorConfig, params: Dict, feats: torch.Tensor,
                    compute_dtype=torch.float32
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """feats [B, T, feat_dim] -> (embedding [B, embed], logits [B, spk] or
    None).  The embedding is segment0's PRE-activation."""
    x = feats.to(compute_dtype)
    for i, ctx in enumerate(cfg.tdnn_contexts):
        p = params[f"tdnn{i}"]
        x = _dot(_splice(x, ctx), p["w"], compute_dtype) + p["b"]
        x = torch.relu(x).to(compute_dtype)
    h = stats_pooling(x.float())                      # [B, 2 * dim]
    embedding = None
    for i in range(len(cfg.segment_dims)):
        p = params[f"segment{i}"]
        pre = torch.matmul(h, p["w"]) + p["b"]
        if i == 0:
            embedding = pre
        h = torch.relu(pre)
    logits = None
    if "output" in params:
        p = params["output"]
        logits = torch.matmul(h, p["w"]) + p["b"]
    return embedding, logits


def xvector_loss(cfg: XVectorConfig, params: Dict, feats: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy speaker-classification training loss."""
    _, logits = xvector_forward(cfg, params, feats)
    return cross_entropy(logits, labels)
