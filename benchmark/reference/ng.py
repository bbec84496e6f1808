"""Plain reference of online natural-gradient preconditioning (Kaldi NG-SGD).

A frozen, single-process copy of kaldi_fp16_tpu_torch/training/
natural_gradient.py at commit de5aca0 (rank-R Fisher factors updated every
`update_period`-th call by an exact eigensolve in float64 on the 2R-wide
subspace, trace-preserving rho, norm-preserving preconditioning), so that a
later change to the port cannot move the benchmark's yardstick.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch

class NGConfig(NamedTuple):
    rank: int = 20                    # Kaldi: 20 in / 80 out by default
    alpha: float = 4.0                # isotropic smoothing
    num_samples_history: int = 2000   # stats half-life in samples
    update_period: int = 4            # update factors every K steps
    epsilon: float = 1e-10
    delta: float = 5e-4               # rho floor relative to max eig


class NGState(NamedTuple):
    v: torch.Tensor       # [R, D] orthonormal rows
    d: torch.Tensor       # [R] eigenvalue excess over rho (>= 0)
    rho: torch.Tensor     # scalar isotropic residual
    t: torch.Tensor       # int32 update counter


def init_ng_state(dim: int, cfg: NGConfig = NGConfig(),
                  device=None) -> NGState:
    """A deterministic orthonormal start (rows of a DCT-like basis), on
    `device` (default: the current CUDA device)."""
    r = min(cfg.rank, max(1, dim // 2))
    i = torch.arange(r, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    v = torch.cos(math.pi * (2 * j + 1) * (i + 1) / (2 * dim))
    v = v * math.sqrt(2.0 / dim)
    v = _orthonormalize(v)
    return NGState(v=v, d=torch.zeros(r, dtype=torch.float32, device=device),
                   rho=torch.tensor(cfg.epsilon, dtype=torch.float32,
                                    device=device),
                   t=torch.zeros((), dtype=torch.int32, device=device))


def _eigh(a: torch.Tensor):
    """torch.linalg.eigh of symmetric a [..., n, n], solved in float64 and
    returned in a's dtype (ascending eigenvalues)."""
    w, u = torch.linalg.eigh(a.double())
    return w.to(a.dtype), u.to(a.dtype)


def _orthonormalize(z: torch.Tensor) -> torch.Tensor:
    """Symmetric (Loewdin) orthonormalization of the rows of z [..., R, D].
    Directions below the fp32 noise floor of the Gram matrix are zeroed
    rather than amplified."""
    g = z @ z.mT
    w, u = _eigh(g)
    top = torch.clamp(w.amax(dim=-1, keepdim=True), min=1e-30)
    keep = w > 1e-6 * top
    inv_sqrt = torch.where(keep, torch.rsqrt(torch.clamp(w, min=1e-30)), 0.0)
    return (u * inv_sqrt[..., None, :]) @ u.mT @ z


def fisher_update(states: Sequence[NGState], xs: Sequence[torch.Tensor],
                  cfg: NGConfig) -> List[NGState]:
    """One online update of each state (of one shape) from its samples."""
    v = torch.stack([s.v for s in states])
    d = torch.stack([s.d for s in states])
    rho = torch.stack([s.rho for s in states])
    t = torch.stack([s.t for s in states])
    _, r, dim = v.shape
    dev = v.device
    counts = [x.shape[0] for x in xs]
    n = torch.tensor([float(c) for c in counts], dtype=torch.float32,
                     device=dev)
    y1 = torch.stack([((x @ vi.mT).mT @ x) / c
                      for x, vi, c in zip(xs, v, counts)])
    tr_c = torch.stack([torch.sum(x * x) / c for x, c in zip(xs, counts)])
    eta = torch.clamp(n / float(cfg.num_samples_history), 1e-3, 0.9)
    eta3 = eta[:, None, None]
    p = y1 - (y1 @ v.mT) @ v
    pn = torch.sqrt(torch.sum(p * p, dim=-1, keepdim=True))
    p = torch.where(pn > 1e-20, p / torch.clamp(pn, min=1e-30), 0.0)
    q = _orthonormalize(p)
    q = q - (q @ v.mT) @ v
    b = torch.cat([v, q], dim=1)
    bcb = torch.stack([(x @ bi.mT).mT @ (x @ bi.mT) / c
                       for x, bi, c in zip(xs, b, counts)])
    bvt = b @ v.mT
    bbt = b @ b.mT
    m = ((1.0 - eta3) * (bvt @ torch.diag_embed(d) @ bvt.mT
                         + rho[:, None, None] * bbt)
         + eta3 * bcb)
    m = 0.5 * (m + m.mT)
    c, uu = _eigh(m)
    c = torch.flip(c, (-1,))
    uu = torch.flip(uu, (-1,))
    c_top = c[:, :r]
    v_new = _orthonormalize(uu[:, :, :r].mT @ b)
    tr_f = (1.0 - eta) * (torch.sum(d, dim=-1) + rho * dim) + eta * tr_c
    rho_new = (tr_f - torch.sum(c_top, dim=-1)) / max(1, dim - r)
    rho_new = torch.maximum(
        rho_new, torch.clamp(cfg.delta * c_top.amax(dim=-1), min=cfg.epsilon))
    d_new = torch.clamp(c_top - rho_new[:, None], min=0.0)
    return [NGState(v=v_new[i], d=d_new[i], rho=rho_new[i], t=t[i] + 1)
            for i in range(len(states))]


def update_due(t: int, cfg: NGConfig) -> bool:
    return t % cfg.update_period == 0


def advance(state: NGState) -> NGState:
    return state._replace(t=state.t + 1)


def _apply_inverse(state: NGState, g: torch.Tensor, cfg: NGConfig,
                   axis: int) -> torch.Tensor:
    """g · P⁻¹ along `axis`, with P = F + (alpha/D) tr(F) I (smoothed):
    P⁻¹ = 1/rho~ (I - Vᵀ diag(d / (d + rho~)) V),  rho~ = rho + smoothing."""
    v, d, rho = state.v, state.d, state.rho
    dim = v.shape[1]
    tr_f = torch.sum(d) + rho * dim
    rho_s = rho + cfg.alpha / dim * tr_f
    g = torch.movedim(g, axis, -1)
    gv = g @ v.mT                              # [..., R]
    corr = (gv * (d / (d + rho_s))[None, :]) @ v
    out = (g - corr) / rho_s
    return torch.movedim(out, -1, axis)


def _norm_preserving(ref: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    num = torch.sqrt(torch.sum(ref.to(out.dtype) ** 2))
    den = torch.sqrt(torch.sum(out ** 2))
    gamma = torch.where(den > 0, num / den, torch.ones_like(den))
    return out * gamma


def precondition_grad(state_in: NGState, state_out: NGState,
                      dw: torch.Tensor, cfg: NGConfig = NGConfig()
                      ) -> torch.Tensor:
    """NG-precondition an accumulated affine gradient dw [D_in, D_out]:
    gamma · P_in⁻¹ dw P_out⁻¹, with gamma such that the Frobenius norm is
    dw's (NG changes the direction, the learning rate the size)."""
    g = _apply_inverse(state_in, dw, cfg, axis=0)
    g = _apply_inverse(state_out, g, cfg, axis=1)
    return _norm_preserving(dw, g)


