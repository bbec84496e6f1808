"""NN building blocks over [B, T, C]: conv1d, pooling, statistics pooling,
layer norm, depthwise-separable conv, squeeze-excite and dropout.

Plain torch ops with the semantics of kaldi_fp16_tpu/ops/nn.py (no Pallas
kernel there, none here; autograd gives the backward passes):

  * conv weights keep the JAX layout [K, Cin, Cout] ("WIO"); F.conv1d
    takes [Cout, Cin / groups, K], so they are permuted at the call;
  * "SAME" is XLA's padding, applied with F.pad (torch's padding="same"
    refuses stride > 1): for an effective window W = (K - 1) * d + 1,
    total = max((ceil(T / s) - 1) * s + W - T, 0), total // 2 on the left
    and the rest on the right; pooling pads with the reduction's identity
    (-inf for max, 0 for the sum);
  * avg_pool1d divides by the number of real frames under each window
    (reduce_window over ones), not by the window;
  * variances are population variances (jnp.var, ddof = 0);
  * products take fp32 operands (a bf16 input is upcast, exact) and fp32
    accumulation, as `preferred_element_type=jnp.float32`, then the
    result is cast back to the input's dtype;
  * dropout draws from a torch.Generator: it keeps JAX's properties
    (identity at train=False or rate 0, inverted scaling, the keep rate),
    not its masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def same_padding(T: int, window: int, stride: int, dilation: int = 1):
    """XLA's SAME padding (left, right) of a window over T frames."""
    eff = (window - 1) * dilation + 1
    out = -(-T // stride)
    total = max((out - 1) * stride + eff - T, 0)
    return total // 2, total - total // 2


def _padding(padding: str, T: int, window: int, stride: int, dilation=1):
    if padding == "SAME":
        return same_padding(T, window, stride, dilation)
    if padding == "VALID":
        return 0, 0
    raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: str,
          dilation: int, groups: int) -> torch.Tensor:
    """x [B, T, Cin], w [K, Cin / groups, Cout] -> fp32 [B, T', Cout]."""
    lo, hi = _padding(padding, x.shape[1], w.shape[0], stride, dilation)
    xt = F.pad(x.float().transpose(1, 2), (lo, hi))
    out = F.conv1d(xt, w.float().permute(2, 1, 0), stride=stride,
                   dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: str = "SAME",
           dilation: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [K, Cin, Cout] -> [B, T', Cout]."""
    out = _conv(x, w, stride, padding, dilation, 1)
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def _windows(x: torch.Tensor, window: int, stride: int, padding: str,
             fill: float) -> torch.Tensor:
    """[B, T, C] -> the windows [B, T', C, window], padded with `fill`."""
    lo, hi = _padding(padding, x.shape[1], window, stride)
    if lo or hi:
        x = F.pad(x.transpose(1, 2), (lo, hi), value=fill).transpose(1, 2)
    return x.unfold(1, window, stride)


def max_pool1d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: str = "VALID") -> torch.Tensor:
    """x [B, T, C] -> [B, T', C]."""
    return _windows(x, window, stride or window, padding,
                    -math.inf).amax(-1)


def avg_pool1d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: str = "VALID") -> torch.Tensor:
    stride = stride or window
    summed = _windows(x, window, stride, padding, 0.0).sum(-1)
    counts = _windows(torch.ones_like(x[:1, :, :1]), window, stride,
                      padding, 0.0).sum(-1)
    return summed / counts


def stats_pooling(x: torch.Tensor, eps: float = 1e-10,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x-vector statistics pooling: concat(mean_t, std_t): [B, T, C] ->
    [B, 2C]; with mask [B, T], over the unmasked frames."""
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        n = torch.clamp(m.sum(dim=1), min=1.0)
        mean = (x * m).sum(dim=1) / n
        var = ((x - mean[:, None, :]) ** 2 * m).sum(dim=1) / n
    else:
        mean = x.mean(dim=1)
        var = x.var(dim=1, unbiased=False)
    std = torch.sqrt(var + eps)
    return torch.cat([mean, std], dim=-1)


def layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-frame layer norm over the channel axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def depthwise_separable_conv1d(x: torch.Tensor, dw: torch.Tensor,
                               pw: torch.Tensor,
                               b: Optional[torch.Tensor] = None,
                               stride: int = 1,
                               padding: str = "SAME") -> torch.Tensor:
    """Depthwise [K, 1, C] (groups = C) then pointwise [1, C, Cout]."""
    depth = _conv(x, dw, stride, padding, 1, x.shape[-1]).to(x.dtype)
    return conv1d(depth, pw, b, stride=1, padding="SAME")


def squeeze_excite(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """SE block over time: squeeze = mean_t, excite = sigmoid MLP gate."""
    squeeze = x.mean(dim=1)                           # [B, C]
    hidden = torch.relu(squeeze @ w1 + b1)
    gate = torch.sigmoid(hidden @ w2 + b2)            # [B, C]
    return x * gate[:, None, :]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            train: bool = True) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate (from
    `generator`) and scaled by 1 / (1 - rate)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    mask = u.to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
