"""Semi-orthogonal constraint for factorized (TDNN-F) layers, on PyTorch.

Port of kaldi_fp16_tpu/training/orthonormal.py (`constrain_orthonormal`
:38, `orthonormal_targets` :62); Kaldi nnet-utils.cc ConstrainOrthonormal:

    P = M M^T                     (M arranged rows <= cols)
    scale^2 = constraint^2        (fixed)  or  tr(PP)/tr(P)  (floating)
    ratio = tr(PP) * rows / tr(P)^2   >= 1, == 1 iff orthogonal
    speed = 0.125, halved when ratio > 1.02, quartered when > 1.1
    M <- M - 4 * speed / scale^2 * (P - scale^2 I) M

The train step applies it every `orthonormal_interval` non-skipped steps,
after the update.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.xconfig import LayerType
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls


@torch.no_grad()
def constrain_orthonormal(w: torch.Tensor, constraint: float,
                          update_speed: float = 0.125) -> torch.Tensor:
    """One constraint step on a weight stored [in, out]; the update runs on
    whichever orientation has rows <= cols and returns [in, out]."""
    transpose = w.shape[1] <= w.shape[0]
    m32 = (w.t() if transpose else w).float()
    with fp32_matmuls():
        p = m32 @ m32.t()                                  # [r, r]
        r = p.shape[0]
        trace_p = torch.trace(p)
        trace_pp = torch.sum(p * p)
        # a fill, not a copy from the host: a CUDA graph captures it
        scale2 = (torch.full((), float(constraint) ** 2, device=w.device)
                  if constraint > 0 else trace_pp / trace_p)
        ratio = trace_pp * r / (trace_p * trace_p)
        speed = torch.where(ratio > 1.1, update_speed * 0.25,
                            torch.where(ratio > 1.02, update_speed * 0.5,
                                        update_speed))
        p2 = p - scale2 * torch.eye(r, dtype=torch.float32, device=w.device)
        m_new = (m32 - (4.0 * speed / scale2) * (p2 @ m32)).to(w.dtype)
    return m_new.t() if transpose else m_new


def orthonormal_targets(model: Model) -> List[Tuple[str, str, float]]:
    """(layer_name, param_name, constraint) for every param whose layer
    spec requests a semi-orthogonal constraint (!= 0)."""
    out = []
    for layer in model.layers:
        c = getattr(layer.spec, "orthonormal_constraint", 0.0)
        if not c:
            continue
        if layer.type == LayerType.TDNNF:
            out.append((layer.name, "linear_w", float(c)))
        elif layer.type == LayerType.PREFINAL:
            out.append((layer.name, "small_w", float(c)))
        elif layer.type == LayerType.LINEAR:
            out.append((layer.name, "w", float(c)))
    return out
