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
the TPU kernels' bf16 split arithmetic, `terms` = 6, 3 or 1 cross
products of the 3-term splits: 6 in the exact den, 1 -- one bf16 pass,
M and the operand rounded to bf16 -- in the fast den) for CUDA tensors;
given `planes` (M split into bf16 planes by ops/den_matmul.py
`split_planes`) the product streams them instead of splitting the fp32 M
in registers (split="pre").  At terms = 1, given `plane` (a `ScanPlane`:
M's one bf16 plane, laid out once for the tensor cores), the product reads
that plane and the operand's one plane, and nothing else: the fast den's
route, bit for bit the three-plane terms = 1 route's numbers, with fewer
bytes.  For CPU tensors they compute the plain
versions below, which the tests compare against: the products in fp32 at
terms = 6 (the 6-term split is within ~3e-7 of it), else in the split
arithmetic itself (ops/den_matmul.py `split_product`).  A CUDA tensor never falls back to a plain
version: if the kernel cannot be built or launched, the call raises.
Each wrapper's `launches` counts its kernel calls (one per scan) on the
fp32-M and three-plane routes, `launches_plane` those on the one-plane
route.
"""

from __future__ import annotations

import torch

from kaldi_fp16_tpu_torch.ops._build import launch, library
from kaldi_fp16_tpu_torch.ops.den_matmul import (
    SPLIT_PRODUCTS, fp32_matmuls, slices, split3, split_product,
)

TK = 128     # chain-axis multiple the fused path requires (pad_chains)
LANE = 128   # batch multiple the fused path requires


def fused_scan_supported(layout, N: int) -> bool:
    """Can the fused scans run this layout / batch? (pallas_den_scan.py:49)"""
    return (len(layout.groups) == 1 and layout.L >= 2
            and layout.F % TK == 0 and N % LANE == 0)


# ---- plain versions --------------------------------------------------------

def _check_terms(terms):
    if terms not in SPLIT_PRODUCTS:
        raise ValueError(f"terms must be 1, 3 or 6, got {terms}")


def _plain_product(A, terms):
    """v -> A @ v as the scans' plain versions compute it at `terms`."""
    _check_terms(terms)
    if terms == 6:
        return lambda v: A @ v
    planes = [p.float() for p in split3(A)]
    return lambda v: split_product(planes, v, terms)


def fused_forward_plain(MT, xs_self, xs_fwd, xs_res, init, *, L, T, leaky,
                        terms=6):
    """Alpha scan as a PyTorch loop over T, in the kernels' formulation.

    MT [Fp, Fp] (= M^T), xs_self [T, L, Fp, N], xs_fwd [T, L-1, Fp, N],
    xs_res [T, Fp, N], init [L, Fp] -> (adash_hist [T, L, Fp, N],
    asum [T, N], logc [T, N], a_final [N])."""
    product = _plain_product(MT, terms)
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
            f = product(adash[L - 1])
            u = adash * xs_self[t]
            u[1:] += adash[:-1] * xs_fwd[t]
            u[0] += f * xs_res[t]
            nxt = u * inv
            a = nxt.sum(dim=(0, 1))
    return hist, asum, logc, a


def fused_backward_plain(M, xs_self, xs_fwd, xs_res, asum, init, real,
                         total_prob, *, L, T, leaky, terms=6):
    """Beta scan as a PyTorch loop over T (reverse), in the kernels'
    formulation.

    M [Fp, Fp], emissions as `fused_forward_plain`, asum [T, N] from it,
    init [L, Fp], real [L, Fp] (1 on real slots), total_prob [N]
    -> beta_hist [T, L, Fp, N]."""
    product = _plain_product(M, terms)
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
            h = product(xs_res[t] * beta[0])
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


def core_panels(X: torch.Tensor) -> torch.Tensor:
    """[R, K] -> the K-major no-swizzle core-matrix panels that the
    tensor-core product reads (csrc/den_mma.cuh, "Layouts"): X[r, k] at
    [r / 128][k / 8][r % 128 / 8][r % 8][k % 8], contiguous."""
    R, K = X.shape
    return X.reshape(R // TK, TK // 8, 8, K // 8, 8).permute(0, 3, 1, 2, 4) \
        .contiguous()


class ScanPlane:
    """M's one bf16 plane, for the scans at terms = 1.

    `plane` is M rounded to bf16 to nearest even ([Fp, Fp], Fp a multiple
    of 128), which is plane 0 of `split3(M)`.  On a card the two layouts
    the product reads are made here, once per matrix: `fwd`, the
    core-matrix panels of M^T (the alpha scan's A), and `bwd`, those of M
    (the beta scan's); 2 x 25.7 MB at Fp = 3584.  On the CPU the plain
    versions read `plane` itself."""

    def __init__(self, plane: torch.Tensor):
        if (plane.dtype != torch.bfloat16 or plane.ndim != 2
                or plane.shape[0] != plane.shape[1] or plane.shape[0] % TK):
            raise ValueError(f"the one plane must be bfloat16 (Fp, Fp) with "
                             f"Fp % {TK} == 0 for terms=1, got {plane.dtype} "
                             f"{tuple(plane.shape)}")
        self.plane = plane.contiguous()
        self.Fp = int(plane.shape[0])
        self.device = plane.device
        self.fwd = self.bwd = None
        if self.device.type == "cuda":
            self.fwd = core_panels(self.plane.t())
            self.bwd = core_panels(self.plane)


def _plane_operand(plane, planes, terms, M):
    """Check the one-plane operand against M and terms."""
    Fp = M.shape[0]
    if not isinstance(plane, ScanPlane):
        raise ValueError(f"plane must be a ScanPlane (M's one bf16 plane, "
                         f"({Fp}, {Fp})) for terms=1, got {type(plane)}")
    if terms != 1:
        raise ValueError(f"the one plane ({plane.Fp}, {plane.Fp}) is the "
                         f"operand of terms=1 alone, got terms={terms}")
    if planes is not None:
        raise ValueError(f"give the one plane ({plane.Fp}, {plane.Fp}) or "
                         f"the planes {tuple(planes.shape)} at terms={terms}, "
                         f"not both")
    if plane.Fp != Fp or plane.device != M.device:
        raise ValueError(f"the one plane is ({plane.Fp}, {plane.Fp}) on "
                         f"{plane.device} at terms={terms}; M is "
                         f"{tuple(M.shape)} on {M.device}")


def _operand(M, planes, plane, Fp, forward):
    """(the product's A operand, its C code `pre`): the fp32 M (0), its
    bf16 planes (1), or the one plane's panels for the scan's direction
    (2)."""
    if plane is not None:
        return (plane.fwd if forward else plane.bwd), 2
    if planes is None:
        return M, 0
    if (tuple(planes.shape) != (3, Fp, Fp) or planes.dtype != torch.bfloat16
            or planes.device != M.device):
        raise ValueError(f"planes must be bfloat16 (3, {Fp}, {Fp}) on "
                         f"{M.device}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")
    return planes, 1


def _workspace(L, Fp, N, dev, pre):
    """(state [2, L, Fp, N], parts [2, Fp / chunk, N], the operand's
    panels: one bf16 plane on the one-plane route (pre 2), else three;
    slice partials, K slices)."""
    n_planes = 1 if pre == 2 else 3
    nch = Fp // library().den_scan_row_block()
    S = slices(Fp, N, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((2, L, Fp, N), **f32), torch.empty((2, nch, N), **f32),
            torch.empty(n_planes * Fp * N, dtype=torch.bfloat16, device=dev),
            torch.empty((S, Fp, N), **f32), S)


def _check_cuda(dev, Fp, N):
    if dev.type != "cuda":
        raise ValueError(f"no den_scan kernel for {dev}")
    if Fp % TK or N % LANE:
        raise ValueError(f"the den_scan kernels need Fp % {TK} == 0 and "
                         f"N % {LANE} == 0, got Fp={Fp}, N={N}")


def fused_forward(M, xs_self, xs_fwd, xs_res, init, *, L, T, leaky,
                  terms=6, planes=None, plane=None):
    """Alpha scan (see `fused_forward_plain`, which takes M^T).  M is the
    untransposed [Fp, Fp] matrix: the kernel reads M^T from it (or from
    its bf16 `planes`, if given).  terms: 6, 3 or 1 bf16 cross products
    per product (pallas_den_scan.py:164).  plane: at terms = 1 only, M's
    one bf16 plane (`ScanPlane`), read instead of M."""
    Fp, N = _check(M, xs_self, xs_fwd, xs_res, init, L, T)
    _check_terms(terms)
    if plane is not None:
        _plane_operand(plane, planes, terms, M)
    dev = xs_res.device
    if dev.type == "cpu":
        A = M if plane is None else plane.plane
        return fused_forward_plain(A.t(), xs_self, xs_fwd, xs_res, init,
                                   L=L, T=T, leaky=leaky, terms=terms)
    _check_cuda(dev, Fp, N)
    A, pre = _operand(M, planes, plane, Fp, forward=True)
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32, device=dev)
    asum = torch.empty((T, N), dtype=torch.float32, device=dev)
    logc = torch.empty((T, N), dtype=torch.float32, device=dev)
    a_final = torch.empty((N,), dtype=torch.float32, device=dev)
    state, parts, panels, ws, S = _workspace(L, Fp, N, dev, pre)
    launch("den_scan_forward", dev, A, pre, xs_self, xs_fwd, xs_res, init,
           state, parts, panels, ws, hist, asum, logc, a_final, L, Fp, N, T,
           S, terms, float(leaky))
    if pre == 2:
        fused_forward.launches_plane += 1
    else:
        fused_forward.launches += 1
    return hist, asum, logc, a_final


def fused_backward(M, xs_self, xs_fwd, xs_res, asum, init, real, total_prob,
                   *, L, T, leaky, terms=6, planes=None, plane=None):
    """Beta scan (see `fused_backward_plain`); `terms`, `planes` and
    `plane` as `fused_forward`."""
    Fp, N = _check(M, xs_self, xs_fwd, xs_res, init, L, T)
    _check_terms(terms)
    if plane is not None:
        _plane_operand(plane, planes, terms, M)
    dev = xs_res.device
    real = real.to(torch.float32)
    for name, x, shape in (("asum", asum, (T, N)), ("real", real, (L, Fp)),
                           ("total_prob", total_prob, (N,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if dev.type == "cpu":
        return fused_backward_plain(M if plane is None else plane.plane,
                                    xs_self, xs_fwd, xs_res, asum, init,
                                    real, total_prob, L=L, T=T, leaky=leaky,
                                    terms=terms)
    _check_cuda(dev, Fp, N)
    A, pre = _operand(M, planes, plane, Fp, forward=False)
    hist = torch.empty((T, L, Fp, N), dtype=torch.float32, device=dev)
    state, parts, panels, ws, S = _workspace(L, Fp, N, dev, pre)
    tot = torch.empty((N,), dtype=torch.float32, device=dev)
    launch("den_scan_backward", dev, A, pre, xs_self, xs_fwd, xs_res, asum,
           init, real.contiguous(), total_prob, state, parts, panels, ws,
           tot, hist, L, Fp, N, T, S, terms, float(leaky))
    if pre == 2:
        fused_backward.launches_plane += 1
    else:
        fused_backward.launches += 1
    return hist


fused_forward.launches = fused_forward.launches_plane = 0
fused_backward.launches = fused_backward.launches_plane = 0
