"""Structured denominator forward-backward on PyTorch.

Port of `StructuredKernels` (kaldi_fp16_tpu/chain/den_structured.py:350-770),
exact mode only.  The graph is decomposed on the host (den_layout.py) into
chains: self-loops become an elementwise multiply on an [L, F] slot
layout, in-chain arcs a shift along L, and the residual chain-end ->
chain-start arcs one dense [F, F] matrix M applied per frame.  The
recursions below hold no gathers or scatters, only elementwise ops,
slices and the M product.

Kaldi semantics kept from the JAX package (denominator.py docstring):
x = exp(clip(nnet, -30, 30)); leaky HMM alpha' = alpha + sum(alpha) *
leaky * init; per-frame rescale by 1/sum(alpha) with log corrections
("safe" divides where the sum is 0); all states final.

Two scan implementations, as in the JAX package (`scan_impl`):

  "loop"   the T-step recursions are Python loops (the JAX package's
           lax.scan).  Each in-scan M product (n = N <= 128 columns) goes to
           the hand-written CUDA kernels through `DenMatmul`
           (ops/den_matmul.py), 2*T applications per forward-backward.
  "fused"  each recursion is one call of the fused scan kernels
           (ops/den_scan.py, csrc/den_scan.cu), which fuse every frame's M
           product with its elementwise update.  Needs one chain-length
           group with L >= 2, hoisted emissions and N % 128 == 0; the chain
           axis is padded to a multiple of 128 (`pad_chains`) once, here,
           and the whole instance (the loop path it takes for other batch
           sizes, and the posteriors) then runs on the padded layout, as in
           the JAX package.

"auto" resolves to "fused" on a card and to "loop" on the CPU
(`resolve_scan_impl`): on the H100 the fused scans' tensor-core products
take the den forward-backward from the loop's host-bound 27-39 ms to
~15 ms (PERF.md), while on the CPU the plain loop is what the tests
compare with the JAX package's XLA scan.  Dispatch depends on
shapes only: a build or launch failure raises
and never switches the path.  The wide bulk-posterior product stays an
fp32 torch.matmul, as the JAX package left it to XLA.  No op here uses
float atomics (the per-pdf reduce is a product against a stored one-hot,
not index_add_), so repeated runs on one card are bit-identical.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import ChainLayout, pad_chains
from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.ops.den_matmul import (
    DenMatmul, fp32_matmuls, split_planes,
)
from kaldi_fp16_tpu_torch.ops.den_scan import (
    fused_backward, fused_forward, fused_scan_supported,
)

SB = 128   # pdf block width of the posterior one-hot reduce
AC = 128   # slots per chunk of the posterior one-hot reduce
KERNEL_MAX_N = 128   # widest vector the in-scan kernel path takes


def resolve_scan_impl(scan_impl: str, device: torch.device) -> str:
    """"auto" -> "fused" on a CUDA device, "loop" elsewhere; other values
    unchanged.  "fused" still runs the loop where the layout or batch does
    not fit the fused scans (`fused_scan_supported`)."""
    if scan_impl != "auto":
        return scan_impl
    return "fused" if torch.device(device).type == "cuda" else "loop"


class StructuredKernels:
    """Device-side forward/backward over a ChainLayout (exact mode).

    matmul_impl: "kernel" sends every in-scan M product (n <= 128) through
    `DenMatmul` (the CUDA kernel on a card, its plain version on the CPU);
    "plain" sends them to torch.matmul, for comparisons.
    scan_impl: "auto" ("fused" on a card, else "loop"), "loop" or
    "fused" (module docstring).
    split: where the kernels split M into bf16 terms, "kernel" (in
    registers, from the fp32 M) or "pre" (once, into planes that every
    product streams); the loop's DenMatmul and the fused scans both use it.
    device: default the current CUDA device.
    """

    def __init__(self, layout: ChainLayout, leaky: float,
                 hoist_bytes: int = 1 << 30, matmul_impl: str = "kernel",
                 scan_impl: str = "auto", split: str = "kernel",
                 device=None):
        if matmul_impl not in ("kernel", "plain"):
            raise ValueError(f"matmul_impl must be 'kernel' or 'plain', "
                             f"got {matmul_impl!r}")
        if split not in ("kernel", "pre"):
            raise ValueError(f"split must be 'kernel' or 'pre', got {split!r}")
        if scan_impl not in ("auto", "fused", "loop"):
            raise ValueError(f"scan_impl must be 'auto', 'fused' or 'loop', "
                             f"got {scan_impl!r}")
        dev = resolve_device(device)
        self.scan_impl = resolve_scan_impl(scan_impl, dev)
        # the fused scans need the chain axis padded to the row-tile width;
        # the inert fake chains change nothing on the loop path
        self._fused_ready = (self.scan_impl == "fused"
                             and len(layout.groups) == 1 and layout.L >= 2)
        if self._fused_ready:
            layout = pad_chains(layout)
        self.lay = layout
        self.leaky = float(leaky)
        self.hoist_bytes = hoist_bytes
        L, F = layout.L, layout.F

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.M = t(layout.M).contiguous()                          # [F, F]
        self._kernel = (DenMatmul(self.M, dev, split=split)
                        if matmul_impl == "kernel" else None)
        # the fused scans' split="pre" operand (the planes DenMatmul made)
        self._planes = None
        if self._fused_ready and split == "pre" and dev.type == "cuda":
            self._planes = (self._kernel.A if self._kernel is not None
                            else split_planes(self.M, self.M.shape[0]))
        self.self_pdf = t(layout.self_pdf.reshape(-1), torch.long)  # [L*F]
        self.self_coef = t(layout.self_coef)                       # [L, F]
        self.has_fwd = L > 1 and float(np.abs(layout.fwd_coef).sum()) > 0
        self.fwd_pdf = t(layout.fwd_pdf[:max(L - 1, 1)].reshape(-1),
                         torch.long)
        self.fwd_coef = t(layout.fwd_coef[:max(L - 1, 1)])
        self.res_pdf = t(layout.res_pdf, torch.long)               # [F]
        self.res_mask = t(layout.res_mask)                         # [F]
        self.init = t(layout.init)                                 # [L, F]
        self.real = t(layout.real, torch.bool)                     # [L, F]
        self.groups: List[Tuple[int, int, int]] = list(layout.groups)
        self._init_sum = float(layout.init.sum())
        self.scan_used: Optional[str] = None   # set by each forward_backward

        # one-hot reduce over slots -> pdf bins (posteriors), in the JAX
        # package's padded slot order: [L*F self] + [(L-1)*F fwd] + [F res]
        slot_pdf = np.concatenate([
            layout.self_pdf.reshape(-1),
            layout.fwd_pdf[:max(L - 1, 1)].reshape(-1) if self.has_fwd
            else np.zeros(0, np.int32),
            layout.res_pdf,
        ]).astype(np.int64)
        self.n_slots = len(slot_pdf)
        P = layout.num_pdfs
        order = np.argsort(slot_pdf, kind="stable")
        sk = slot_pdf[order]
        NB = max(1, -(-P // SB))
        bounds = np.searchsorted(sk, np.arange(0, (NB + 1) * SB, SB))
        counts = np.diff(bounds)
        J = max(1, int(np.max(-(-counts // AC))) if len(counts) else 1)
        Ap = NB * J * AC
        perm = np.zeros(Ap, np.int64)
        valid = np.zeros(Ap, bool)
        onehot = np.zeros((NB, J * AC, SB), np.float32)
        for b in range(NB):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            n = hi - lo
            base = b * J * AC
            perm[base:base + n] = order[lo:hi]
            valid[base:base + n] = True
            onehot[b, np.arange(n), sk[lo:hi] - b * SB] = 1.0
        self._post_perm = t(perm, torch.long)
        self._post_valid = t(valid.astype(np.float32))
        # stored transposed, [NB, SB, J*AC], for one batched product
        self._post_onehot_t = t(onehot.transpose(0, 2, 1).copy())
        self._post_NB, self._post_J = NB, J
        self._Pp = NB * SB

    # ---- static slice helpers (chains grouped by length) -------------------

    def _ends(self, a: torch.Tensor) -> torch.Tensor:
        """[L, F, ...] -> [F, ...] rows = chain-end values, in chain order."""
        parts = [a[l - 1, lo:hi] for (l, lo, hi) in self.groups]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def _add_to_ends(self, g: torch.Tensor, out: torch.Tensor) -> None:
        """out[l-1, chains of length l] += g (inverse of _ends), in place."""
        for (l, lo, hi) in self.groups:
            out[l - 1, lo:hi] += g[lo:hi]

    def _apply_M(self, v: torch.Tensor, transpose: bool) -> torch.Tensor:
        """(M^T if transpose else M) @ v, v [F, ...]."""
        n = v.numel() // v.shape[0]
        if self._kernel is not None and n <= KERNEL_MAX_N:
            return self._kernel.apply(v.contiguous(), transpose)
        M = self.M.t() if transpose else self.M
        return (M @ v.reshape(v.shape[0], -1)).reshape(v.shape)

    # ---- emissions ---------------------------------------------------------

    def _emissions(self, x_tpn: torch.Tensor, hoist: bool):
        """Per-class emission coefficients of frame t, as a function of t:
        (xs_self [L, F, N], xs_fwd [L-1, F, N] or None, xs_res [F, N]).

        Hoisted, the tables are computed for all T frames at once
        (den_structured.py:535-545); otherwise per frame (:521-530)."""
        L, F = self.lay.L, self.lay.F

        def per_frame(x_pn):
            xs_self = (x_pn.index_select(0, self.self_pdf)
                       .reshape(L, F, -1) * self.self_coef[:, :, None])
            xs_fwd = None
            if self.has_fwd:
                xs_fwd = (x_pn.index_select(0, self.fwd_pdf)
                          .reshape(L - 1, F, -1) * self.fwd_coef[:, :, None])
            xs_res = (x_pn.index_select(0, self.res_pdf)
                      * self.res_mask[:, None])
            return xs_self, xs_fwd, xs_res

        if not hoist:
            return lambda t: per_frame(x_tpn[t])
        xs_self, xs_fwd, xs_res = self._hoisted_emissions(x_tpn)
        return lambda t: (xs_self[t], None if xs_fwd is None else xs_fwd[t],
                          xs_res[t])

    def _hoisted_emissions(self, x_tpn: torch.Tensor):
        """All T frames' tables at once (den_structured.py:535-545):
        xs_self [T, L, F, N], xs_fwd [T, L-1, F, N] or None, xs_res
        [T, F, N], each contiguous."""
        L, F = self.lay.L, self.lay.F
        T = x_tpn.shape[0]
        xs_self = (x_tpn.index_select(1, self.self_pdf)
                   .reshape(T, L, F, -1) * self.self_coef[None, :, :, None])
        xs_fwd = None
        if self.has_fwd:
            xs_fwd = (x_tpn.index_select(1, self.fwd_pdf)
                      .reshape(T, L - 1, F, -1)
                      * self.fwd_coef[None, :, :, None])
        xs_res = (x_tpn.index_select(1, self.res_pdf)
                  * self.res_mask[None, :, None])
        return xs_self, xs_fwd, xs_res

    # ---- core --------------------------------------------------------------

    @torch.no_grad()
    def forward_backward(self, nnet_output: torch.Tensor,
                         compute_grad: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """nnet_output [N, T, P] -> (log_prob [N], posteriors [N, T, P])."""
        with fp32_matmuls():
            return self._forward_backward(nnet_output, compute_grad)

    def _forward_backward(self, nnet_output, compute_grad):
        lay = self.lay
        L, F, P = lay.L, lay.F, lay.num_pdfs
        N, T, _ = nnet_output.shape
        leaky = self.leaky
        init = self.init[:, :, None]                       # [L, F, 1]

        x = torch.exp(torch.clamp(nnet_output.float(), -30.0, 30.0))
        x_tpn = x.permute(1, 2, 0).contiguous()            # [T, P, N]

        # hoist budget: 2 passes of (2L+1)*F*N fp32 per frame
        hoist = T * (2 * L + 1) * F * N * 4 * 2 <= self.hoist_bytes
        self.scan_used = "fused" if self._use_fused(N, hoist) else "loop"
        if self.scan_used == "fused":
            return self._forward_backward_fused(x_tpn, N, T, compute_grad)
        frame = self._emissions(x_tpn, hoist)

        # ---- forward (alpha recursion) -------------------------------------
        alpha0 = init.expand(L, F, N)
        asum_prev = alpha0.sum(dim=(0, 1))
        adash = alpha0 + asum_prev[None, None, :] * leaky * init
        adash_hist = torch.empty((T, L, F, N), dtype=torch.float32,
                                 device=x.device)
        asum_hist = torch.empty((T, N), dtype=torch.float32, device=x.device)
        logcs = torch.empty((T, N), dtype=torch.float32, device=x.device)
        for t in range(T):
            adash_hist[t] = adash
            asum_hist[t] = asum_prev
            xs_self, xs_fwd, xs_res = frame(t)
            nxt = adash * xs_self                               # self loops
            if self.has_fwd:
                nxt[1:] += adash[:-1] * xs_fwd                  # chain arcs
            f = self._apply_M(self._ends(adash), transpose=True)
            nxt[0] += f * xs_res                                # residual
            safe = asum_prev > 0
            nxt = torch.where(safe[None, None, :],
                              nxt / asum_prev[None, None, :], nxt)
            logcs[t] = torch.where(safe, torch.log(asum_prev), 0.0)
            asum = nxt.sum(dim=(0, 1))
            adash = nxt + asum[None, None, :] * leaky * init
            asum_prev = asum

        total_prob = adash.sum(dim=(0, 1))
        log_prob = torch.log(total_prob) + logcs.sum(dim=0)
        if not compute_grad:
            return log_prob, None

        # ---- backward (beta recursion) -------------------------------------
        inv_total = torch.where(total_prob > 0, 1.0 / total_prob, 0.0)
        beta_dash = torch.where(self.real[:, :, None], inv_total[None, None, :],
                                0.0).expand(L, F, N)

        def leakify(bd):
            tot = leaky * (bd * init).sum(dim=(0, 1))
            return bd + tot[None, None, :]

        beta_next = leakify(beta_dash)
        beta_hist = torch.empty_like(adash_hist)
        for t in range(T - 1, -1, -1):
            # frame t's posteriors use beta at t+1
            beta_hist[t] = beta_next
            xs_self, xs_fwd, xs_res = frame(t)
            asum_t = asum_hist[t]
            inv = torch.where(asum_t > 0, 1.0 / asum_t, 0.0)
            bd = beta_next * xs_self
            if self.has_fwd:
                bd[:-1] += beta_next[1:] * xs_fwd
            h = self._apply_M(xs_res * beta_next[0], transpose=False)
            self._add_to_ends(h, bd)
            bd = bd * inv[None, None, :]
            beta_next = leakify(bd)

        posteriors = self._bulk_posteriors(adash_hist, asum_hist, beta_hist,
                                           x_tpn, N, T, P)
        return log_prob, posteriors

    # ---- fused scans (ops/den_scan.py) --------------------------------------

    def _use_fused(self, N: int, hoist: bool) -> bool:
        """den_structured.py:658-673: shapes only, never a failure."""
        return (self._fused_ready and hoist and self.has_fwd
                and fused_scan_supported(self.lay, N))

    def _forward_backward_fused(self, x_tpn, N, T, compute_grad):
        """den_structured.py:675-701, with the port's [T, N] stats."""
        lay = self.lay
        L, P = lay.L, lay.num_pdfs
        leaky = self.leaky
        xs_self, xs_fwd, xs_res = self._hoisted_emissions(x_tpn)
        adash_hist, asum_hist, logcs, a_fin = fused_forward(
            self.M, xs_self, xs_fwd, xs_res, self.init, L=L, T=T,
            leaky=leaky, planes=self._planes)
        total_prob = a_fin * (1.0 + leaky * self._init_sum)
        log_prob = torch.log(total_prob) + logcs.sum(dim=0)
        if not compute_grad:
            return log_prob, None
        beta_hist = fused_backward(
            self.M, xs_self, xs_fwd, xs_res, asum_hist, self.init,
            self.real, total_prob, L=L, T=T, leaky=leaky,
            planes=self._planes)
        posteriors = self._bulk_posteriors(adash_hist, asum_hist, beta_hist,
                                           x_tpn, N, T, P)
        return log_prob, posteriors

    # ---- bulk posteriors ----------------------------------------------------

    def _bulk_posteriors(self, adash_hist, asum_hist, beta_hist, x_tpn,
                         N, T, P):
        """Per-slot occupation values, reduced into pdf bins chunk by chunk
        (den_structured.py:705-770)."""
        L, F = self.lay.L, self.lay.F
        inv_hist = torch.where(asum_hist > 0, 1.0 / asum_hist, 0.0)   # [T, N]
        bytes_per_frame = self.n_slots * N * 4 * 4
        Tc = int(min(T, max(1, self.hoist_bytes // max(1, bytes_per_frame))))
        nc = -(-T // Tc)
        # balanced chunks: ceil(T/nc) frames each instead of the budget cap,
        # so the last chunk is not mostly empty
        Tc = -(-T // nc)
        NB, J = self._post_NB, self._post_J
        posteriors = torch.empty((N, T, P), dtype=torch.float32,
                                 device=x_tpn.device)
        for t0 in range(0, T, Tc):
            t1 = min(T, t0 + Tc)
            tc = t1 - t0
            ad_s = adash_hist[t0:t1].permute(1, 2, 0, 3)    # [L, F, tc, N]
            be_s = beta_hist[t0:t1].permute(1, 2, 0, 3)
            vals = [(ad_s * be_s * self.self_coef[:, :, None, None])
                    .reshape(L * F, tc, N)]
            if self.has_fwd:
                vals.append((ad_s[:-1] * be_s[1:]
                             * self.fwd_coef[:, :, None, None])
                            .reshape((L - 1) * F, tc, N))
            # residual: f[v] = (M^T @ adash_ends), beta factor per dst; the
            # emission x[t][pdf] multiplies after the per-pdf reduce
            e = self._ends(ad_s).reshape(F, tc * N)
            fmat = self._apply_M(e, transpose=True).reshape(F, tc, N)
            vals.append(fmat * be_s[0] * self.res_mask[:, None, None])
            v = torch.cat(vals, 0).reshape(self.n_slots, tc * N)
            vp = (v.index_select(0, self._post_perm)
                  * self._post_valid[:, None]).reshape(NB, J * AC, tc * N)
            red = torch.bmm(self._post_onehot_t, vp)          # [NB, SB, tc*N]
            red = red.reshape(self._Pp, tc, N)[:P]
            x_pt = x_tpn[t0:t1].permute(1, 0, 2)               # [P, tc, N]
            post = red * x_pt * inv_hist[t0:t1][None, :, :]
            posteriors[:, t0:t1] = post.permute(2, 1, 0)
        return posteriors
