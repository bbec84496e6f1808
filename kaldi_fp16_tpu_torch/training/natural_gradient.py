"""Online natural-gradient preconditioning (Kaldi NG-SGD family), on PyTorch.

Port of kaldi_fp16_tpu/training/natural_gradient.py (`NGConfig` :42,
`NGState` :51, `init_ng_state` :58, `_orthonormalize` :73,
`_fisher_update` :84, `ng_update` :144, `_apply_inverse` :157,
`precondition_grad` :174, `precondition_samples` :191), in fp32.

Each affine site keeps a rank-R estimate of two Fisher factors, the
input covariance E[x xᵀ] (x extended with a 1.0 column for the bias) and
the output-derivative covariance E[g gᵀ]:

    F ≈ Vᵀ diag(d) V + rho I,   V [R, D] orthonormal, d the excess over rho,

updated every `update_period`-th call from a minibatch's sample matrix X
[N, D] by an exact eigensolve of the updated Fisher restricted to the
2R-dimensional subspace span(rows V ∪ rows V·C), C = XᵀX/N, with a
trace-preserving rho.  Because the preconditioners act linearly on the
sample space, the NG update of an accumulated gradient is
P_in⁻¹ dW P_out⁻¹ (`precondition_grad`), rescaled to dW's Frobenius norm.

`fisher_update` updates several states of one shape together: its
eigensolves (three per state) run as batched calls, one per shape, since
each `torch.linalg.eigh` on a CUDA tensor waits for the device.  They run
in float64 on matrices of at most 2R x 2R: cuSOLVER's float32 eigh on the
H100 put the factors of some sites outside the NG tests' bars from the
float64 result, where LAPACK's float32 (the CPU's, and the JAX package's
there) stays well inside them (tools/ng_precision.py).  Eigenvectors come
back up to sign and, in degenerate subspaces, in another basis than
JAX's, so what compares across the two frameworks is d, rho, t,
Vᵀdiag(d)V and the preconditioned gradient, never V
(tests/test_torch_natural_gradient.py).

Where a state keeps half its dimensions (2R >= D - 1: the flagship's
128-wide bottleneck outputs and cnn1-4's outputs at rank 80) the update
is ill-conditioned in float32 on any device: the enrichment directions'
Gram matrix has an eigenvalue within rounding of the 1e-6 keep
threshold, and the direction kept amplifies rounding by the inverse
square root of that eigenvalue, so float32 results there lie outside the
bars from the float64 ones, in the JAX package as here.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.parallel.data_parallel import all_reduce_sum


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
    device = resolve_device(device)
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


def _means(sums: Sequence[Sequence[torch.Tensor]], counts: Sequence[int],
           group=None):
    """Per state i, each sums[k][i] / counts[i], the global count.  Under
    a data group the sums are every rank's (one all-reduce); the division
    is the single process's, so world 1 gives its bits."""
    if group is not None:
        sums = all_reduce_sum([torch.stack(list(s)) for s in sums], group)
    return [torch.stack([s_i / n for s_i, n in zip(s, counts)])
            for s in sums]


def fisher_update(states: Sequence[NGState], xs: Sequence[torch.Tensor],
                  cfg: NGConfig, group=None,
                  counts: Optional[Sequence[Optional[int]]] = None
                  ) -> List[NGState]:
    """One online update of each state from its sample matrix xs[i]
    [N_i, D] (states of one shape [R, D]; N may differ).  The x-dependent
    products run per state, everything else batched over the states.

    Under a data group (parallel/mesh.py; the data x seq group of a mesh)
    xs[i] are this rank's samples, and the update is that of every
    rank's: N is the global count (counts[i], default `world` times this
    rank's: every rank holding rows of one shape), and the sample means
    (V C and tr C, then B C Bᵀ, which depends on V C) are of every rank's
    sums, in two all-reduces; the samples never leave their rank."""
    v = torch.stack([s.v for s in states])                    # [S, R, D]
    d = torch.stack([s.d for s in states])                    # [S, R]
    rho = torch.stack([s.rho for s in states])                # [S]
    t = torch.stack([s.t for s in states])
    _, r, dim = v.shape
    dev = v.device

    world = 1 if group is None else group.world
    counts = [x.shape[0] * world if c is None else c
              for x, c in zip(xs, counts or [None] * len(xs))]
    n = torch.tensor([float(c) for c in counts], dtype=torch.float32,
                     device=dev)
    # enrichment directions: V C [S, R, D] orthogonalized against V,
    # row-normalized; tr C beside it
    y1, tr_c = _means([[(x @ vi.mT).mT @ x for x, vi in zip(xs, v)],
                       [torch.sum(x * x) for x in xs]], counts, group)
    eta = torch.clamp(n / float(cfg.num_samples_history), 1e-3, 0.9)
    eta3 = eta[:, None, None]
    p = y1 - (y1 @ v.mT) @ v
    pn = torch.sqrt(torch.sum(p * p, dim=-1, keepdim=True))
    p = torch.where(pn > 1e-20, p / torch.clamp(pn, min=1e-30), 0.0)
    q = _orthonormalize(p)                     # may have 0 rows
    q = q - (q @ v.mT) @ v                     # re-orthogonalize vs v
    b = torch.cat([v, q], dim=1)               # [S, 2R, D]

    (bcb,) = _means([[xb.mT @ xb for xb in (x @ bi.mT
                                            for x, bi in zip(xs, b))]],
                    counts, group)
    bvt = b @ v.mT                             # [S, 2R, R]
    bbt = b @ b.mT
    # F' = (1-eta) (Vᵀ d V + rho I) + eta C, projected onto B; d is the
    # excess over rho, so rho multiplies bbt
    m = ((1.0 - eta3) * (bvt @ torch.diag_embed(d) @ bvt.mT
                         + rho[:, None, None] * bbt)
         + eta3 * bcb)
    m = 0.5 * (m + m.mT)
    c, uu = _eigh(m)                           # ascending
    c = torch.flip(c, (-1,))
    uu = torch.flip(uu, (-1,))
    c_top = c[:, :r]
    v_new = _orthonormalize(uu[:, :, :r].mT @ b)

    # trace-preserving isotropic residual; tr F = sum(d) + rho*dim
    tr_f = (1.0 - eta) * (torch.sum(d, dim=-1) + rho * dim) + eta * tr_c
    rho_new = (tr_f - torch.sum(c_top, dim=-1)) / max(1, dim - r)
    # rho floor: epsilon absolute, delta relative to the top eigenvalue
    rho_new = torch.maximum(
        rho_new, torch.clamp(cfg.delta * c_top.amax(dim=-1), min=cfg.epsilon))
    d_new = torch.clamp(c_top - rho_new[:, None], min=0.0)
    t_new = t + 1
    return [NGState(v=v_new[i], d=d_new[i], rho=rho_new[i], t=t_new[i])
            for i in range(len(states))]


def update_due(t: int, cfg: NGConfig) -> bool:
    """Whether a call at counter value t folds in the statistics."""
    return t % cfg.update_period == 0


def advance(state: NGState) -> NGState:
    """A call that does not fold in statistics: the counter only."""
    return state._replace(t=state.t + 1)


def ng_update(state: NGState, x: torch.Tensor,
              cfg: NGConfig = NGConfig()) -> NGState:
    """Update the Fisher estimate from samples x [N, D] every
    cfg.update_period-th call (reads the counter on the host)."""
    if update_due(int(state.t), cfg):
        return fisher_update([state], [x], cfg)[0]
    return advance(state)


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


def precondition_samples(state: NGState, x: torch.Tensor,
                         cfg: NGConfig = NGConfig()) -> torch.Tensor:
    """gamma · X P⁻¹ for per-sample preconditioning (rows = samples);
    gamma preserves the Frobenius norm (Kaldi PreconditionDirections)."""
    return _norm_preserving(x, _apply_inverse(state, x, cfg, axis=-1))
