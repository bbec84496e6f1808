"""Probability-domain leaky-HMM denominator forward-backward on PyTorch.

Port of `DenominatorComputation` (kaldi_fp16_tpu/chain/denominator.py),
exact mode only, with both of its layouts:

  structured  a den graph that decomposes into HMM chains plus a dense
              phone-LM matrix (every real den.fst, and
              `make_phone_lm_den_fst`) runs chain/den_structured.py: the
              in-scan M products on the den_matmul kernel, or the whole
              recursions on the fused scan kernels (`scan_impl="fused"`).
  blocked     any other graph (and any graph with `layout="blocked"`) runs
              the generic gather path below: arcs grouped three ways (by
              dst, by src, by pdf) into 128-wide key blocks of 128-slot
              chunks (`_BlockedOrder`); the forward scan runs dst-native
              and the beta scan src-native, each reducing arc values into
              per-state sums as one batched product against a stored fp32
              one-hot (TF32 off), as the JAX package's einsums do; the
              posteriors come from one bulk pass in pdf order, chunked over
              frames, whose per-pdf reduce is that same product
              (`posterior_reduce="einsum"`) or the hand-written
              segment_reduce kernel (`"kernel"`, the JAX `"pallas"`;
              ops/segment_reduce.py).  `"auto"`, the default, resolves to
              the kernel on a card, where its segmented row sum beats the
              one-hot product end to end (PERF.md), and to the product on
              the CPU, where the tests compare it with the JAX einsum
              (`resolve_posterior_reduce`).

Kaldi semantics (the JAX module docstring): x = exp(clip(nnet, -30, 30));
leaky HMM alpha' = alpha + sum(alpha) * leaky * init; per-frame rescale by
1/sum(alpha) with log corrections; all states final.  The JAX dst/src
de-alias padding chunk (an XLA scheduling workaround) and `mode="fast"`
are not ported.  `denominator_forward_backward` is the JAX module's
functional wrapper (:396-412), with its cache of computations.  No op uses float atomics, so repeats on one card are
bit-identical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.ops.segment_reduce import segment_reduce

SB = 128   # state/pdf block width
AC = 128   # arcs per chunk


def resolve_posterior_reduce(posterior_reduce: str,
                             device: torch.device) -> str:
    """"auto" -> "kernel" on a CUDA device, "einsum" elsewhere; other
    values unchanged."""
    if posterior_reduce != "auto":
        return posterior_reduce
    return "kernel" if torch.device(device).type == "cuda" else "einsum"


class _BlockedOrder:
    """Arcs grouped into 128-wide blocks of a sort key, padded to AC chunks
    (kaldi_fp16_tpu/chain/denominator.py:65-119).

    Host numpy: `onehot` [NB, J, AC, SB] (all-zero rows on padding slots),
    `num_blocks`, `chunks`, `padded`.  Torch tensors on `device`: `local`
    [NB, J*AC] int32 (the slot's key within its block, SB on padding: the
    segment_reduce labels), `src`, `dst`, `pdf` [padded] int32 and `prob`
    [padded] float32 (0 on padding).  `secondary` orders arcs within each
    key block, for gather locality.
    """

    def __init__(self, keys: np.ndarray, num_keys: int, graph,
                 secondary: Optional[np.ndarray] = None, device=None):
        keys = np.asarray(keys)
        if secondary is not None:
            order = np.lexsort((np.asarray(secondary), keys)).astype(np.int64)
        else:
            order = np.argsort(keys, kind="stable").astype(np.int64)
        sk = keys[order]
        NB = max(1, -(-num_keys // SB))
        bounds = np.searchsorted(sk, np.arange(0, (NB + 1) * SB, SB))
        counts = np.diff(bounds)
        J = max(1, int(np.max(-(-counts // AC))) if len(counts) else 1)
        Ap = NB * J * AC
        perm = np.zeros(Ap, np.int64)
        valid = np.zeros(Ap, bool)
        onehot = np.zeros((NB, J * AC, SB), np.float32)
        local = np.full(Ap, SB, np.int32)
        for b in range(NB):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            n = hi - lo
            base = b * J * AC
            perm[base:base + n] = order[lo:hi]
            valid[base:base + n] = True
            onehot[b, np.arange(n), sk[lo:hi] - b * SB] = 1.0
            local[base:base + n] = sk[lo:hi] - b * SB
        self.num_blocks = NB
        self.chunks = J
        self.padded = Ap
        self.onehot = onehot.reshape(NB, J, AC, SB)
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(a, device=dev)

        self.local = t(local.reshape(NB, J * AC))
        self.src = t(np.asarray(graph.src)[perm].astype(np.int32))
        self.dst = t(np.asarray(graph.dst)[perm].astype(np.int32))
        self.pdf = t(np.asarray(graph.pdf)[perm].astype(np.int32))
        self.prob = t(np.where(valid, np.asarray(graph.prob)[perm], 0.0)
                      .astype(np.float32))


class DenominatorComputation:
    """Device-resident denominator graph with forward / forward-backward
    (batched over sequences), as in the JAX package.

    layout: "auto" (structured when the graph decomposes, else blocked),
    "structured" (ValueError if it does not decompose) or "blocked".
    `layout_used` says which one runs.
    matmul_impl, scan_impl, split: the structured layout's options
    (den_structured.py): "kernel" / "plain" den matmul, "auto" ("fused"
    on a card, "loop" on the CPU) / "loop" / "fused" scans, "kernel" /
    "pre" split of M.
    device: default the current CUDA device; CPU runs pass "cpu".
    posterior_reduce: the blocked layout's per-pdf posterior reduce,
    "auto" ("kernel" on a card, else "einsum"), "einsum" (one-hot
    product) or "kernel" (segment_reduce); `posterior_reduce` holds the
    resolved value.
    """

    def __init__(self, graph: DenominatorGraph, leaky: float = 1e-5,
                 hoist_bytes: int = 1 << 30, matmul_impl: str = "kernel",
                 scan_impl: str = "auto", layout: str = "auto",
                 posterior_reduce: str = "auto", split: str = "kernel",
                 device=None):
        if layout not in ("auto", "structured", "blocked"):
            raise ValueError(f"layout must be 'auto', 'structured' or "
                             f"'blocked', got {layout!r}")
        if posterior_reduce not in ("auto", "einsum", "kernel"):
            raise ValueError(f"posterior_reduce must be 'auto', 'einsum' or "
                             f"'kernel', got {posterior_reduce!r}")
        dev = resolve_device(device)
        self.leaky = leaky
        self.hoist_bytes = hoist_bytes
        self.posterior_reduce = resolve_posterior_reduce(posterior_reduce,
                                                         dev)
        self._structured = None
        if layout in ("auto", "structured"):
            lay = analyze_chain_structure(graph)
            if lay is not None:
                self._structured = StructuredKernels(
                    lay, leaky, hoist_bytes, matmul_impl=matmul_impl,
                    scan_impl=scan_impl, split=split, device=dev)
            elif layout == "structured":
                raise ValueError(
                    "layout='structured' requested but the graph does not "
                    "decompose (multiple self-loops, pdf conflicts, or too "
                    "many chains for the dense residual matrix)")
        self.layout_used = "structured" if self._structured else "blocked"
        if self._structured is not None:
            return

        S, P = graph.num_states, graph.num_pdfs
        # secondary within-block sort = the gather index each order uses
        self._dst_o = _BlockedOrder(graph.dst, S, graph, graph.src, dev)
        self._src_o = _BlockedOrder(graph.src, S, graph, graph.dst, dev)
        self._pdf_o = _BlockedOrder(graph.pdf, P, graph, graph.src, dev)

        def onehot_t(order):
            # [NB, J, AC, SB] -> [NB, SB, J*AC] for one batched product
            nb = order.num_blocks
            return torch.as_tensor(
                order.onehot.reshape(nb, -1, SB).transpose(0, 2, 1).copy(),
                device=dev)

        self._oh_dst = onehot_t(self._dst_o)
        self._oh_src = onehot_t(self._src_o)
        self._oh_pdf = (onehot_t(self._pdf_o)
                        if self.posterior_reduce == "einsum" else None)
        self._Sp = self._dst_o.num_blocks * SB
        self._Pp = self._pdf_o.num_blocks * SB
        init_pad = np.zeros(self._Sp, np.float32)
        init_pad[:S] = graph.initial
        self._init = torch.as_tensor(init_pad, device=dev)
        self._real = (torch.arange(self._Sp, device=dev) < S)[:, None]

    # -- blocked one-hot reduction (the scatter replacement) -----------------

    @staticmethod
    def _reduce(vals: torch.Tensor, onehot_t: torch.Tensor) -> torch.Tensor:
        """[Ap, ...] arc values -> [NB*SB, ...] per-key block sums, as one
        fp32 batched product against the stored one-hots (denominator.py
        :205-229)."""
        nb, _, ja = onehot_t.shape
        rest = vals.shape[1:]
        out = torch.bmm(onehot_t, vals.reshape(nb, ja, -1))
        return out.reshape((nb * SB,) + tuple(rest))

    # -- core ---------------------------------------------------------------

    @torch.no_grad()
    def _forward_backward(self, nnet_output: torch.Tensor,
                          compute_grad: bool):
        if self._structured is not None:
            return self._structured.forward_backward(nnet_output,
                                                     compute_grad)
        with fp32_matmuls():
            return self._blocked_forward_backward(nnet_output, compute_grad)

    def _blocked_forward_backward(self, nnet_output, compute_grad):
        """denominator.py:233-372: nnet_output [N, T, P] ->
        (log_prob [N], posteriors [N, T, P])."""
        N, T, P = nnet_output.shape
        Sp = self._Sp
        leaky = self.leaky
        init = self._init[:, None]                            # [Sp, 1]
        dsto, srco, pdfo = self._dst_o, self._src_o, self._pdf_o
        dev = nnet_output.device

        x = torch.exp(torch.clamp(nnet_output.float(), -30.0, 30.0))
        x_tpn = x.permute(1, 2, 0).contiguous()               # [T, P, N]

        # hoist budget covers the two scan-order score tables
        hoist = T * (dsto.padded + srco.padded) * N * 4 <= self.hoist_bytes

        def scores(order):
            """Per-arc emission scores of frame t, x[t][pdf] * prob."""
            if hoist:
                table = (x_tpn.index_select(1, order.pdf)
                         * order.prob[None, :, None])        # [T, Ap, N]
                return lambda t: table[t]
            return lambda t: (x_tpn[t].index_select(0, order.pdf)
                              * order.prob[:, None])

        # ---- forward (dst-native order) -------------------------------------
        xtp = scores(dsto)
        alpha0 = init.expand(Sp, N)
        asum_prev = alpha0.sum(dim=0)
        adash = alpha0 + asum_prev[None, :] * leaky * init
        adash_hist = torch.empty((T, Sp, N), dtype=torch.float32, device=dev)
        asum_hist = torch.empty((T, N), dtype=torch.float32, device=dev)
        logcs = torch.empty((T, N), dtype=torch.float32, device=dev)
        for t in range(T):
            adash_hist[t] = adash
            asum_hist[t] = asum_prev
            av = adash.index_select(0, dsto.src) * xtp(t)    # [Ap, N]
            nxt = self._reduce(av, self._oh_dst)
            safe = asum_prev > 0
            nxt = torch.where(safe[None, :], nxt / asum_prev[None, :], nxt)
            logcs[t] = torch.where(safe, torch.log(asum_prev), 0.0)
            asum = nxt.sum(dim=0)
            adash = nxt + asum[None, :] * leaky * init
            asum_prev = asum
        del xtp

        total_prob = adash.sum(dim=0)
        log_prob = torch.log(total_prob) + logcs.sum(dim=0)
        if not compute_grad:
            return log_prob, None

        # ---- backward: beta recursion only (src-native order) --------------
        # beta'[T] = 1/total_prob on all real states (all states final)
        beta_dash = torch.where(
            self._real, torch.where(total_prob[None, :] > 0,
                                    1.0 / total_prob[None, :], 0.0), 0.0)

        def leakify(bd):
            tot = leaky * (bd * init).sum(dim=0)
            return bd + tot[None, :]

        beta_next = leakify(beta_dash.expand(Sp, N))
        xtp = scores(srco)
        beta_hist = torch.empty_like(adash_hist)
        for t in range(T - 1, -1, -1):
            # frame t's posteriors use beta at t+1
            beta_hist[t] = beta_next
            asum_t = asum_hist[t]
            inv = torch.where(asum_t > 0, 1.0 / asum_t, 0.0)
            bv = beta_next.index_select(0, srco.dst) * xtp(t)
            bd = self._reduce(bv, self._oh_src) * inv[None, :]
            beta_next = leakify(bd)
        del xtp

        return log_prob, self._bulk_posteriors(adash_hist, asum_hist,
                                               beta_hist, x_tpn, N, T, P)

    def frames_per_chunk(self, N: int, T: int) -> int:
        """Frames per chunk of the blocked bulk posterior pass: the
        budget's cap, then balanced, ceil(T / chunks), so the last chunk is
        not mostly empty.  The pass makes ceil(T / this) chunks."""
        bytes_per_frame = self._pdf_o.padded * N * 4 * 4
        Tc = int(min(T, max(1, self.hoist_bytes // max(1, bytes_per_frame))))
        return -(-T // -(-T // Tc))

    def _bulk_posteriors(self, adash_hist, asum_hist, beta_hist, x_tpn,
                         N, T, P):
        """gamma[t][pdf] = sum over arcs of that pdf of alpha'[t][src] * prob
        * beta[t+1][dst], times x[t][pdf] / alpha_sum[t]; pdf order, chunks
        of Tc frames (denominator.py:317-372)."""
        pdfo = self._pdf_o
        inv_hist = torch.where(asum_hist > 0, 1.0 / asum_hist, 0.0)  # [T, N]
        Tc = self.frames_per_chunk(N, T)
        posteriors = torch.empty((N, T, P), dtype=torch.float32,
                                 device=x_tpn.device)
        for t0 in range(0, T, Tc):
            t1 = min(T, t0 + Tc)
            tc = t1 - t0
            ad_st = adash_hist[t0:t1].permute(1, 0, 2)       # [Sp, tc, N]
            be_st = beta_hist[t0:t1].permute(1, 0, 2)
            # x[t][pdf] depends on (t, pdf) only, so it multiplies after
            # the per-pdf reduce
            gv = (ad_st.index_select(0, pdfo.src)
                  * be_st.index_select(0, pdfo.dst)
                  * pdfo.prob[:, None, None])                 # [Ap, tc, N]
            if self.posterior_reduce == "kernel":
                red = segment_reduce(
                    gv.reshape(pdfo.num_blocks, pdfo.chunks * AC, tc * N),
                    pdfo.local, sb=SB)
            else:
                red = self._reduce(gv.reshape(pdfo.padded, tc * N),
                                   self._oh_pdf)
            red = red.reshape(self._Pp, tc, N)[:P]
            x_pt = x_tpn[t0:t1].permute(1, 0, 2)              # [P, tc, N]
            post = red * x_pt * inv_hist[t0:t1][None, :, :]
            posteriors[:, t0:t1] = post.permute(2, 1, 0)
        return posteriors

    # -- public API ---------------------------------------------------------

    def forward(self, nnet_output: torch.Tensor) -> torch.Tensor:
        logp, _ = self._forward_backward(nnet_output, compute_grad=False)
        return logp

    def forward_backward(self, nnet_output: torch.Tensor
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """nnet_output [N, T, P] -> (log_prob [N], posteriors [N, T, P])."""
        return self._forward_backward(nnet_output, compute_grad=True)


# a DenominatorComputation per (graph, leaky, mode, device), as the JAX
# module's functional wrapper memoizes one per (graph, leaky, mode): a
# fresh one per call would redo the host-side layout work.  Keyed by
# id(graph), each entry holding its graph so the id cannot be recycled;
# the port's key adds the device, since a computation lives on one.
_den_cache: dict = {}


def denominator_forward_backward(graph: DenominatorGraph,
                                 nnet_output: torch.Tensor,
                                 leaky: float = 1e-5, mode: str = "exact"):
    """Functional wrapper: nnet_output [N, T, P] -> (log_prob [N],
    posteriors [N, T, P]), on nnet_output's device."""
    if mode == "fast":
        raise ValueError("den mode='fast' is not ported: it was revoked in "
                         "the JAX package (ROADMAP.md queue 1 item 5)")
    if mode != "exact":
        raise ValueError(f"mode must be 'exact', got {mode!r}")
    key = (id(graph), float(leaky), mode, nnet_output.device)
    hit = _den_cache.get(key)
    if hit is None or hit[0] is not graph:
        hit = (graph, DenominatorComputation(graph, leaky,
                                             device=nnet_output.device))
        if len(_den_cache) > 16:
            _den_cache.clear()
        _den_cache[key] = hit
    return hit[1].forward_backward(nnet_output)
