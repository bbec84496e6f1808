"""The structured denominator's fused alpha and beta scans.

The port of kaldi_fp16_tpu/ops/pallas_den_scan.py (`fused_forward`,
`fused_backward`).  Each scan runs the whole T-frame recursion of
chain/den_structured.py in one call: per frame, the dense phone-LM
product (M^T forward, M backward) fused with the elementwise update that
follows it, with the lazy per-frame normalisation of the TPU kernels:

  forward   a = sum(nxt);  adash = nxt + a * leaky * init
            f = M^T @ adash[L-1]
            nxt[l] = (adash[l] xs_self[l] + adash[l-1] xs_fwd[l-1]
                      + [l = 0] f xs_res) / a
  backward  beta = bd + tot;  h = M @ (xs_res * beta[0])
            bd[l] = (beta[l] xs_self[l] + beta[l+1] xs_fwd[l]
                     + [l = L-1] h) / asum[t];  tot = leaky * sum(bd init)

Conventions (den_structured.py's): adash_hist[t], asum[t] and logc[t]
describe the state ENTERING frame t; beta_hist[t] is beta at frame t + 1;
log_prob = log(a_final * (1 + leaky * sum(init))) + sum(logc).

The TPU kernels return their per-frame stats as a [T, 8, N] array (rows
beyond 0 and 1 are sublane padding: row 0 = asum, row 1 = logc) and
a_final as [8, N] (row 0); the port returns the two rows as [T, N]
tensors and a_final as [N].  `fused_backward` takes asum [T, N] (stats
row 0) and total_prob [N] (row 0 of the TPU's [8, N]).

`fused_forward` / `fused_backward` launch the hand-written CUDA kernels
(csrc/den_scan.cu: one C call per scan enqueues the 3T frame launches;
each frame's product runs on the tensor cores through csrc/den_mma.cuh in
the TPU kernels' 6-term bf16 split) for CUDA tensors; given `planes` (M
split into bf16 planes by ops/den_matmul.py `split_planes`) the product
streams them instead of splitting the fp32 M in registers (split="pre").
For CPU tensors they compute the plain versions below, in fp32, which
the tests compare against.  A CUDA tensor never falls back to a plain
version: if the kernel cannot be built or launched, the call raises.
Each wrapper's `launches` counts its kernel calls (one per scan).
"""

from __future__ import annotations

import torch

from kaldi_fp16_tpu_torch.ops._build import launch, library
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls, slices

TK = 128     # chain-axis multiple the fused path requires (pad_chains)
LANE = 128   # batch multiple the fused path requires


def fused_scan_supported(layout, N: int) -> bool:
    """Can the fused scans run this layout / batch? (pallas_den_scan.py:49)"""
    return (len(layout.groups) == 1 and layout.L >= 2
            and layout.F % TK == 0 and N % LANE == 0)


# ---- plain versions --------------------------------------------------------

def fused_forward_plain(MT, xs_self, xs_fwd, xs_res, init, *, L, T, leaky):
    """Alpha scan as a PyTorch loop over T, in the kernels' formulation.

    MT [Fp, Fp] (= M^T), xs_self [T, L, Fp, N], xs_fwd [T, L-1, Fp, N],
    xs_res [T, Fp, N], init [L, Fp] -> (adash_hist [T, L, Fp, N],
    asum [T, N], logc [T, N], a_final [N])."""
    Fp, N = xs_res.shape[1], xs_res.shape[2]
    dev = xs_res.device
    nxt = init[:, :, None].expand(L, Fp, N)
    a = init.sum().expand(N)
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32, device=dev)
    asum = torch.empty((T, N), dtype=torch.float32, device=dev)
    logc = torch.empty((T, N), dtype=torch.float32, device=dev)
    with fp32_matmuls():
        for t in range(T):
            safe = a > 0
            asum[t] = a
            logc[t] = torch.where(safe, torch.log(a), 0.0)
            inv = torch.where(safe, 1.0 / a, 1.0)
            adash = nxt + a * leaky * init[:, :, None]
            hist[t] = adash
            f = MT @ adash[L - 1]
            u = adash * xs_self[t]
            u[1:] += adash[:-1] * xs_fwd[t]
            u[0] += f * xs_res[t]
            nxt = u * inv
            a = nxt.sum(dim=(0, 1))
    return hist, asum, logc, a


def fused_backward_plain(M, xs_self, xs_fwd, xs_res, asum, init, real,
                         total_prob, *, L, T, leaky):
    """Beta scan as a PyTorch loop over T (reverse), in the kernels'
    formulation.

    M [Fp, Fp], emissions as `fused_forward_plain`, asum [T, N] from it,
    init [L, Fp], real [L, Fp] (1 on real slots), total_prob [N]
    -> beta_hist [T, L, Fp, N]."""
    Fp, N = xs_res.shape[1], xs_res.shape[2]
    init3 = init[:, :, None]
    inv_total = torch.where(total_prob > 0, 1.0 / total_prob, 0.0)
    bd = real.to(torch.float32)[:, :, None] * inv_total
    tot = leaky * (bd * init3).sum(dim=(0, 1))
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32,
                       device=xs_res.device)
    with fp32_matmuls():
        for t in range(T - 1, -1, -1):
            beta = bd + tot
            hist[t] = beta
            inv = torch.where(asum[t] > 0, 1.0 / asum[t], 0.0)
            h = M @ (xs_res[t] * beta[0])
            b = beta * xs_self[t]
            b[:-1] += beta[1:] * xs_fwd[t]
            b[L - 1] += h
            bd = b * inv
            tot = leaky * (bd * init3).sum(dim=(0, 1))
    return hist


# ---- wrappers --------------------------------------------------------------

def _check(M, xs_self, xs_fwd, xs_res, init, L, T):
    Fp = M.shape[0]
    N = xs_res.shape[-1]
    want = {"M": (Fp, Fp), "xs_self": (T, L, Fp, N),
            "xs_fwd": (T, L - 1, Fp, N), "xs_res": (T, Fp, N),
            "init": (L, Fp)}
    for name, x in zip(want, (M, xs_self, xs_fwd, xs_res, init)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != xs_res.device:
            raise ValueError(f"{name} is on {x.device}, xs_res on "
                             f"{xs_res.device}")
    if L < 1 or T < 1:
        raise ValueError(f"need L >= 1 and T >= 1, got L={L}, T={T}")
    return Fp, N


def _operand(M, planes, Fp):
    """The product's A operand: the fp32 M, or its bf16 planes."""
    if planes is None:
        return M, 0
    if (tuple(planes.shape) != (3, Fp, Fp) or planes.dtype != torch.bfloat16
            or planes.device != M.device):
        raise ValueError(f"planes must be bfloat16 (3, {Fp}, {Fp}) on "
                         f"{M.device}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")
    return planes, 1


def _workspace(L, Fp, N, dev):
    """(state [2, L, Fp, N], parts [2, Fp / chunk, N], panels, slice
    partials, K slices)."""
    nch = Fp // library().den_scan_row_block()
    S = slices(Fp, N, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((2, L, Fp, N), **f32), torch.empty((2, nch, N), **f32),
            torch.empty(3 * Fp * N, dtype=torch.bfloat16, device=dev),
            torch.empty((S, Fp, N), **f32), S)


def _check_cuda(dev, Fp, N):
    if dev.type != "cuda":
        raise ValueError(f"no den_scan kernel for {dev}")
    if Fp % TK or N % LANE:
        raise ValueError(f"the den_scan kernels need Fp % {TK} == 0 and "
                         f"N % {LANE} == 0, got Fp={Fp}, N={N}")


def fused_forward(M, xs_self, xs_fwd, xs_res, init, *, L, T, leaky,
                  planes=None):
    """Alpha scan (see `fused_forward_plain`, which takes M^T).  M is the
    untransposed [Fp, Fp] matrix: the kernel reads M^T from it (or from
    its bf16 `planes`, if given)."""
    Fp, N = _check(M, xs_self, xs_fwd, xs_res, init, L, T)
    dev = xs_res.device
    if dev.type == "cpu":
        return fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                   L=L, T=T, leaky=leaky)
    _check_cuda(dev, Fp, N)
    A, pre = _operand(M, planes, Fp)
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32, device=dev)
    asum = torch.empty((T, N), dtype=torch.float32, device=dev)
    logc = torch.empty((T, N), dtype=torch.float32, device=dev)
    a_final = torch.empty((N,), dtype=torch.float32, device=dev)
    state, parts, panels, ws, S = _workspace(L, Fp, N, dev)
    launch("den_scan_forward", dev, A, pre, xs_self, xs_fwd, xs_res, init,
            state, parts, panels, ws, hist, asum, logc, a_final, L, Fp, N, T,
            S, float(leaky))
    fused_forward.launches += 1
    return hist, asum, logc, a_final


def fused_backward(M, xs_self, xs_fwd, xs_res, asum, init, real, total_prob,
                   *, L, T, leaky, planes=None):
    """Beta scan (see `fused_backward_plain`); `planes` as `fused_forward`."""
    Fp, N = _check(M, xs_self, xs_fwd, xs_res, init, L, T)
    dev = xs_res.device
    real = real.to(torch.float32)
    for name, x, shape in (("asum", asum, (T, N)), ("real", real, (L, Fp)),
                           ("total_prob", total_prob, (N,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if dev.type == "cpu":
        return fused_backward_plain(M, xs_self, xs_fwd, xs_res, asum, init,
                                    real, total_prob, L=L, T=T, leaky=leaky)
    _check_cuda(dev, Fp, N)
    A, pre = _operand(M, planes, Fp)
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32, device=dev)
    state, parts, panels, ws, S = _workspace(L, Fp, N, dev)
    tot = torch.empty((N,), dtype=torch.float32, device=dev)
    launch("den_scan_backward", dev, A, pre, xs_self, xs_fwd, xs_res, asum,
            init, real.contiguous(), total_prob, state, parts, panels, ws,
            tot, hist, L, Fp, N, T, S, float(leaky))
    fused_backward.launches += 1
    return hist


fused_forward.launches = 0
fused_backward.launches = 0
