"""Batched exact decoding on the device: dense and arc-parallel Viterbi,
and exact beam-pruned lattices.

The torch counterpart of kaldi_fp16_tpu/decode/tpu_viterbi.py, with its
segment layout only:

  * `DenseViterbiDecoder`: the max-plus recursion over a dense [S, S]
    transition table, one frame at a time, traceback on the device;
  * `SparseViterbiDecoder`: arcs as a flat list sorted by destination
    (`ArcGraph`; the arc ids of that order are the backpointers), scores
    state-major [S, B], per frame

        cand = (score[src] + w) + scale * ll[pdf]          # [A, B]
        nxt  = segment max of cand into dst                # [S, B]
        bp   = smallest arc id reaching nxt                # [S, B]

    with the traceback on the device, so only [T, B] int32 arc ids leave
    it; above `bp_hist_limit` bytes of backpointers the forward keeps
    scores at chunk starts only and the traceback recomputes each chunk;
  * `DeviceLatticeDecoder`: a min-plus alpha scan and a reverse beta scan
    that emits the bit-packed keep-mask of the arcs within the lattice
    beam; checkpointed alphas above `alpha_hist_limit`; the mask ships
    dense or compacted on the device, and the host assembles `Lattice`
    objects (decode/lattice.py).

The segment reductions are `scatter_reduce_` with "amax" / "amin" into a
tensor filled with the reduction's identity (NEG_INF, +INF, int32 max):
max and min do not depend on the order of their operands, so a decode
repeats bit for bit.  Ties go to the smallest arc id, as in the JAX
package.  Not ported: the ELL and tree-ELL layouts (they exist to avoid
the TPU's slow scatter and give the segment layout's results), the
`mesh` argument.  The streaming decoders (decode/streaming.py) run
`_viterbi_frames` and `_traceback` chunk by chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
from kaldi_fp16_tpu_torch.device import resolve_device

NEG_INF = -1.0e30
INF = -NEG_INF
_INT32_MAX = torch.iinfo(torch.int32).max
# packbits order: the first arc of each group of 8 is the byte's top bit
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


@dataclass
class DenseGraph:
    """Dense max-plus form of a decoding graph."""
    trans: np.ndarray      # [S, S] float32: -graph_cost, NEG_INF if no arc
    pdf: np.ndarray        # [S, S] int32: acoustic row for the arc (or 0)
    ilabel: np.ndarray     # [S, S] int32: input label of the best arc
    olabel: np.ndarray     # [S, S] int32: output label of the best arc
    final: np.ndarray      # [S] float32: -final_cost, NEG_INF if not final
    start: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    @classmethod
    def from_graph(cls, g: DecodingGraph) -> "DenseGraph":
        """Best emitting arc per (src, dst); requires an epsilon-free graph
        (compose/epsilon-remove offline for HCLG with eps arcs)."""
        S = g.num_states
        if len(g.eps_dst):
            raise ValueError("dense decoder requires an epsilon-free graph")
        trans = np.full((S, S), NEG_INF, dtype=np.float32)
        pdf = np.zeros((S, S), dtype=np.int32)
        ilabel = np.zeros((S, S), dtype=np.int32)
        olabel = np.zeros((S, S), dtype=np.int32)
        for s in range(S):
            for a in range(g.em_row_ptr[s], g.em_row_ptr[s + 1]):
                d = int(g.em_dst[a])
                w = -float(g.em_weight[a])
                if w > trans[s, d]:
                    trans[s, d] = w
                    pdf[s, d] = g.pdf_of(int(g.em_ilabel[a]))
                    ilabel[s, d] = int(g.em_ilabel[a])
                    olabel[s, d] = int(g.em_olabel[a])
        final = np.where(np.isfinite(g.final_cost), -g.final_cost,
                         NEG_INF).astype(np.float32)
        return cls(trans=trans, pdf=pdf, ilabel=ilabel, olabel=olabel,
                   final=final, start=g.start)


@dataclass
class ArcGraph:
    """Flat arc-list (dst-sorted) max-plus form of a decoding graph."""
    src: np.ndarray        # [A] int32
    dst: np.ndarray        # [A] int32, ascending
    pdf: np.ndarray        # [A] int32 acoustic row
    ilabel: np.ndarray     # [A] int32
    olabel: np.ndarray     # [A] int32
    weight: np.ndarray     # [A] float32, -graph_cost (max-plus)
    final: np.ndarray      # [S] float32, -final_cost or NEG_INF
    start: int
    num_states: int

    @classmethod
    def from_graph(cls, g: DecodingGraph) -> "ArcGraph":
        if len(g.eps_dst):
            raise ValueError("arc decoder requires an epsilon-free graph")
        S = g.num_states
        A = len(g.em_dst)
        src = np.repeat(np.arange(S, dtype=np.int32),
                        np.diff(g.em_row_ptr).astype(np.int64))
        if g.ilabel_to_pdf is not None:
            pdf = g.ilabel_to_pdf[g.em_ilabel].astype(np.int32)
        else:
            pdf = (g.em_ilabel - 1).astype(np.int32)
        order = np.argsort(g.em_dst, kind="stable").astype(np.int64)
        final = np.where(np.isfinite(g.final_cost), -g.final_cost,
                         NEG_INF).astype(np.float32)
        assert A == len(src)
        return cls(src=src[order], dst=g.em_dst[order].astype(np.int32),
                   pdf=pdf[order], ilabel=g.em_ilabel[order].astype(np.int32),
                   olabel=g.em_olabel[order].astype(np.int32),
                   weight=(-g.em_weight[order]).astype(np.float32),
                   final=final, start=g.start, num_states=S)


def _segment_layout(layout: str, mesh) -> str:
    """The one layout ported: 'auto' and 'segment' both mean it."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: data-parallel decoding is not ported yet (ROADMAP "
            "queue 1 item 3)")
    if layout in ("ell", "tree"):
        raise NotImplementedError(
            f"layout={layout!r} is not ported (ROADMAP queue 1 item 2): it "
            f"avoids the TPU's scatter and gives the segment layout's "
            f"results; use layout='segment'")
    if layout not in ("auto", "segment"):
        raise ValueError(f"unknown layout {layout!r}")
    return "segment"


def _pick_chunk(T: int, S: int, B: int, limit: int) -> int:
    """Chunk size for the checkpointed decode kernels: ~sqrt(T)
    minimizes max(live block, checkpoint array) = max(chunk, T/chunk) *
    S*B*4 bytes; clamp down if even the live block would exceed the
    limit.  No divisibility requirement — the kernels handle a ragged
    final chunk."""
    chunk = max(1, int(math.isqrt(T)))
    per_frame = S * B * 4
    if chunk * per_frame > limit:
        chunk = max(1, limit // per_frame)
    return min(chunk, T)


def _loglikes(loglikes, device) -> torch.Tensor:
    """[B, T, P] float32 on `device`."""
    return torch.as_tensor(loglikes, dtype=torch.float32, device=device)


class _Arcs:
    """An ArcGraph's arrays on the device, and the frame steps over them."""

    def __init__(self, a: ArcGraph, acoustic_scale: float,
                 device: torch.device):
        def idx(x):
            return torch.from_numpy(x.astype(np.int64)).to(device)

        self.A, self.S = len(a.src), a.num_states
        self.src, self.dst, self.pdf = idx(a.src), idx(a.dst), idx(a.pdf)
        self.weight = torch.from_numpy(a.weight).to(device)
        self.gcost = torch.from_numpy(-a.weight).to(device)  # tropical cost
        self.final = torch.from_numpy(a.final).to(device)
        fc = np.where(a.final > NEG_INF / 2, -a.final, -NEG_INF)
        self.fcost = torch.from_numpy(fc.astype(np.float32)).to(device)
        self.arc_ids = torch.arange(self.A, dtype=torch.int32,
                                    device=device)[:, None]
        self.scale = torch.tensor(acoustic_scale, dtype=torch.float32,
                                  device=device)
        self.bit_weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                                        device=device)
        self.start = a.start
        self._rows_B = None

    def start_scores(self, B: int) -> torch.Tensor:
        """[S, B] Viterbi scores before the first frame: 0 at the start
        state, NEG_INF elsewhere."""
        score = torch.full((self.S, B), NEG_INF, device=self.src.device)
        score[self.start] = 0.0
        return score

    def rows(self, B: int):
        """Flat [A, B] indices of the src, dst and pdf rows of a row-major
        [rows, B] tensor, for torch.take: on an H100 it gathers 390K rows of
        16 floats in 36 us, index_select, gather and advanced indexing in
        237 us.  Kept for the last batch size."""
        if self._rows_B != B:
            cols = torch.arange(B, device=self.src.device)
            self._rows = tuple(i[:, None] * B + cols
                               for i in (self.src, self.dst, self.pdf))
            self._rows_B = B
        return self._rows

    def viterbi_step(self, score, ll_t, bp_out=None):
        """score [S, B], ll_t [P, B] -> the next score; with bp_out
        [S, B] int32, the smallest arc id reaching each maximum (int32
        max where no arc enters the state)."""
        src_rows, dst_rows, pdf_rows = self.rows(score.shape[1])
        cand = torch.take(score, src_rows) + self.weight[:, None]
        cand += self.scale * torch.take(ll_t, pdf_rows)
        dst = self.dst[:, None].expand_as(cand)
        nxt = torch.full_like(score, NEG_INF).scatter_reduce_(
            0, dst, cand, "amax", include_self=True)
        if bp_out is not None:
            win = cand >= torch.take(nxt, dst_rows)
            ids = torch.where(win, self.arc_ids, self.A)
            bp_out.fill_(_INT32_MAX).scatter_reduce_(0, dst, ids, "amin",
                                                    include_self=True)
        return nxt

    def arc_costs(self, ac_t):
        """ac_t [P, B] acoustic costs -> graph + scaled acoustic [A, B]."""
        return self.gcost[:, None] + self.scale * torch.take(
            ac_t, self.rows(ac_t.shape[1])[2])

    def alpha_step(self, alpha, ac_t, out):
        """Min-plus forward: alpha [S, B] -> out [S, B] (INF if no arc)."""
        cand = torch.take(alpha, self.rows(alpha.shape[1])[0]) \
            + self.arc_costs(ac_t)
        return out.fill_(INF).scatter_reduce_(
            0, self.dst[:, None].expand_as(cand), cand, "amin",
            include_self=True)

    def beta_step(self, beta_next, alpha_t, ac_t, thr, keep, packed_out):
        """Min-plus backward into SOURCE states; the keep-mask of the arcs
        with alpha[src] + cost + beta[dst] <= thr goes packed (MSB first
        along the arc axis) into packed_out [ceil(A/8), B] uint8.  keep is
        a [8 * ceil(A/8), B] bool buffer whose padding rows stay False."""
        src_rows, dst_rows, _ = self.rows(beta_next.shape[1])
        cand = self.arc_costs(ac_t) + torch.take(beta_next, dst_rows)
        beta = torch.full_like(beta_next, INF).scatter_reduce_(
            0, self.src[:, None].expand_as(cand), cand, "amin",
            include_self=True)
        tot = torch.take(alpha_t, src_rows) + cand
        torch.le(tot, thr[None, :], out=keep[:self.A])
        bits = keep.view(torch.uint8).view(-1, 8, keep.shape[1])
        torch.sum(bits * self.bit_weights[None, :, None], 1,
                  dtype=torch.uint8, out=packed_out)
        return beta


def _traceback(g: _Arcs, bps, state, arcs_out):
    """Walk backpointers bps [n, S, B] in reverse from states `state` [B]
    (int64), writing the arcs taken into arcs_out [n, B]; returns the
    states before the first frame."""
    for t in range(bps.shape[0] - 1, -1, -1):
        arc = bps[t].gather(0, state[None])[0]
        arcs_out[t] = arc
        safe = arc.clamp(0, g.A - 1).long()
        state = torch.where(arc < g.A, g.src[safe], state)
    return state


def _viterbi_frames(g: _Arcs, score, ll_tpb):
    """The frame recursion from `score` [S, B] over ll_tpb [T, P, B] ->
    (score after the last frame, backpointers [T, S, B] int32).  The
    offline decode and the streaming decoders' chunks both run it, so a
    stream fed chunk by chunk reproduces the offline decode bit for bit."""
    bps = torch.empty((ll_tpb.shape[0], g.S, score.shape[1]),
                      dtype=torch.int32, device=score.device)
    for t in range(ll_tpb.shape[0]):
        score = g.viterbi_step(score, ll_tpb[t], bps[t])
    return score, bps


def _arc_viterbi(g: _Arcs, ll_tpb, B: int):
    """ll_tpb [T, P, B] -> (best [B], last [B], arcs_taken [T, B] int32),
    with the whole backpointer table [T, S, B] on the device."""
    T = ll_tpb.shape[0]
    score, bps = _viterbi_frames(g, g.start_scores(B), ll_tpb)
    total = score + g.final[:, None]
    best, last = total.amax(0), total.argmax(0)
    arcs = torch.empty((T, B), dtype=torch.int32, device=ll_tpb.device)
    _traceback(g, bps, last, arcs)
    return best, last, arcs


def _arc_viterbi_ckpt(g: _Arcs, ll_tpb, B: int, chunk: int):
    """_arc_viterbi with CHECKPOINTED scores: the forward keeps the score
    at each chunk's start only ([T // chunk, S, B]); the traceback
    recomputes one chunk's backpointers at a time ([chunk, S, B] live),
    the ragged last chunk (T % chunk frames) first."""
    T = ll_tpb.shape[0]
    nc = T // chunk
    dev = ll_tpb.device
    score = g.start_scores(B)
    ckpts = torch.empty((nc, g.S, B), device=dev)
    for c in range(nc):
        ckpts[c] = score
        for t in range(c * chunk, (c + 1) * chunk):
            score = g.viterbi_step(score, ll_tpb[t])
    score_T1 = score
    for t in range(nc * chunk, T):
        score = g.viterbi_step(score, ll_tpb[t])
    total = score + g.final[:, None]
    best, last = total.amax(0), total.argmax(0)

    bps = torch.empty((chunk, g.S, B), dtype=torch.int32, device=dev)
    arcs = torch.empty((T, B), dtype=torch.int32, device=dev)

    def remat_back(state, score_c0, t0, n):
        s = score_c0
        for i in range(n):
            s = g.viterbi_step(s, ll_tpb[t0 + i], bps[i])
        return _traceback(g, bps[:n], state, arcs[t0:t0 + n])

    state = last
    if T > nc * chunk:
        state = remat_back(state, score_T1, nc * chunk, T - nc * chunk)
    for c in range(nc - 1, -1, -1):
        state = remat_back(state, ckpts[c], c * chunk, chunk)
    return best, last, arcs


def _lattice_masks(g: _Arcs, ac_tpb, beam, B: int):
    """ac_tpb [T, P, B] acoustic costs -> (packed keep-masks
    [T, ceil(A/8), B] uint8, best [B]), with the alpha history
    [T, S, B] on the device."""
    T = ac_tpb.shape[0]
    dev = ac_tpb.device
    alphas = torch.empty((T, g.S, B), device=dev)
    alphas[0].fill_(INF)
    alphas[0, g.start] = 0.0
    alpha_T = torch.empty((g.S, B), device=dev)
    for t in range(T):
        g.alpha_step(alphas[t], ac_tpb[t], alphas[t + 1] if t + 1 < T
                     else alpha_T)
    best, thr = _threshold(g, alpha_T, beam)
    packed, keep = _mask_buffers(g, T, B, dev)
    beta = g.fcost[:, None].expand(g.S, B).contiguous()
    for t in range(T - 1, -1, -1):
        beta = g.beta_step(beta, alphas[t], ac_tpb[t], thr, keep, packed[t])
    return packed, best


def _lattice_masks_ckpt(g: _Arcs, ac_tpb, beam, B: int, chunk: int):
    """_lattice_masks with CHECKPOINTED alpha: the forward keeps alpha
    at chunk starts ([T // chunk, S, B]); the reverse sweep recomputes
    each chunk's alphas ([chunk, S, B] live) before its beta and mask
    steps, the ragged last chunk first."""
    T = ac_tpb.shape[0]
    nc = T // chunk
    dev = ac_tpb.device
    ckpts = torch.empty((nc, g.S, B), device=dev)
    alpha = torch.full((g.S, B), INF, device=dev)
    alpha[g.start] = 0.0
    spare = torch.empty_like(alpha)
    for c in range(nc):
        ckpts[c] = alpha
        for t in range(c * chunk, (c + 1) * chunk):
            alpha, spare = g.alpha_step(alpha, ac_tpb[t], spare), alpha
    alpha_T1 = alpha.clone()
    for t in range(nc * chunk, T):
        alpha, spare = g.alpha_step(alpha, ac_tpb[t], spare), alpha
    best, thr = _threshold(g, alpha, beam)
    packed, keep = _mask_buffers(g, T, B, dev)
    alphas = torch.empty((chunk, g.S, B), device=dev)

    def remat_bwd(beta, alpha_c0, t0, n):
        alphas[0] = alpha_c0
        for i in range(n - 1):
            g.alpha_step(alphas[i], ac_tpb[t0 + i], alphas[i + 1])
        for i in range(n - 1, -1, -1):
            beta = g.beta_step(beta, alphas[i], ac_tpb[t0 + i], thr, keep,
                               packed[t0 + i])
        return beta

    beta = g.fcost[:, None].expand(g.S, B).contiguous()
    if T > nc * chunk:
        beta = remat_bwd(beta, alpha_T1, nc * chunk, T - nc * chunk)
    for c in range(nc - 1, -1, -1):
        beta = remat_bwd(beta, ckpts[c], c * chunk, chunk)
    return packed, best


def _threshold(g: _Arcs, alpha_T, beam):
    """(best [B], keep threshold [B]); no reachable final state => keep
    NOTHING: with best ~ INF, fp32 saturation would otherwise make
    `tot <= best + beam` true for every arc with one finite endpoint."""
    best = (alpha_T + g.fcost[:, None]).amin(0)
    inf = torch.tensor(INF, dtype=torch.float32, device=best.device)
    thr = torch.where(best > inf / 2, -inf, best + beam)
    return best, thr


def _mask_buffers(g: _Arcs, T: int, B: int, device):
    nbytes = -(-g.A // 8)
    packed = torch.empty((T, nbytes, B), dtype=torch.uint8, device=device)
    keep = torch.zeros((8 * nbytes, B), dtype=torch.bool, device=device)
    return packed, keep


class DenseViterbiDecoder:
    """Full (unpruned) batched Viterbi on the device; exact best path."""

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 device=None):
        self.device = resolve_device(device)
        self.dense = DenseGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        dev = self.device
        self._trans = torch.from_numpy(self.dense.trans).to(dev)
        self._pdf = torch.from_numpy(
            self.dense.pdf.astype(np.int64).reshape(-1)).to(dev)
        self._final = torch.from_numpy(self.dense.final).to(dev)
        self._scale = torch.tensor(acoustic_scale, dtype=torch.float32,
                                   device=dev)

    def decode_batch(self, loglikes) -> List[dict]:
        """loglikes [B, T, P] -> list of {words, alignment, total_cost}."""
        ll = _loglikes(loglikes, self.device)
        B, T, _ = ll.shape
        S = self.dense.num_states
        score = torch.full((B, S), NEG_INF, device=self.device)
        score[:, self.dense.start] = 0.0
        bps = torch.empty((T, B, S), dtype=torch.int64, device=self.device)
        for t in range(T):
            # acoustic contribution per (s, d): scale * ll[pdf[s, d]]
            ac = self._scale * ll[:, t].index_select(1, self._pdf) \
                .view(B, S, S)
            cand = score[:, :, None] + self._trans[None] + ac
            score = cand.amax(1)                          # [B, S] over src
            bps[t] = cand.argmax(1)                       # first maximum
        total = score + self._final[None]
        best, last = total.amax(1), total.argmax(1)
        states = torch.empty((T + 1, B), dtype=torch.int64,
                             device=self.device)
        states[T] = last
        for t in range(T - 1, -1, -1):
            states[t] = bps[t].gather(1, states[t + 1][:, None])[:, 0]
        best = best.cpu().numpy()
        states = states.cpu().numpy()
        # the arcs' true input labels (pdf+1 only when no ilabel_to_pdf
        # map exists — transition-id graphs differ)
        il = self.dense.ilabel[states[:-1], states[1:]]          # [T, B]
        ol = self.dense.olabel[states[:-1], states[1:]]
        results = []
        for b in range(B):
            results.append({"words": ol[:, b][ol[:, b] > 0].tolist(),
                            "alignment": il[:, b].tolist(),
                            "total_cost": -float(best[b]),
                            "final_reached": bool(np.isfinite(-best[b]))
                            and best[b] > NEG_INF / 2})
        return results


class SparseViterbiDecoder:
    """Exact batched Viterbi over an epsilon-free graph, arc-parallel on
    the device with on-device traceback (the same results as
    DenseViterbiDecoder).  layout: 'auto' and 'segment' both select the
    segment layout; 'ell' and 'tree' are not ported, nor is `mesh`."""

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 layout: str = "auto", mesh=None, device=None):
        self.layout = _segment_layout(layout, mesh)
        self.device = resolve_device(device)
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        # above this, decode_batch switches to the checkpointed-score
        # path (no [T, S, B] backpointer table; big batches on
        # HCLG-scale graphs)
        self.bp_hist_limit = 1 << 30
        self._g = _Arcs(self.arcs, acoustic_scale, self.device)

    def arc_path(self, loglikes):
        """loglikes [B, T, P] -> (best [B], last [B], arcs_taken [T, B]
        int32), on the device; a graph with no emitting arc has none."""
        ll = _loglikes(loglikes, self.device)
        B, T, _ = ll.shape
        ll_tpb = ll.permute(1, 2, 0).contiguous()               # [T, P, B]
        S = self.arcs.num_states
        if T * S * B * 4 > self.bp_hist_limit:
            # HCLG scale: the [T, S, B] backpointer table would not fit;
            # checkpoint scores and rematerialize per chunk
            chunk = _pick_chunk(T, S, B, self.bp_hist_limit)
            return _arc_viterbi_ckpt(self._g, ll_tpb, B, chunk)
        return _arc_viterbi(self._g, ll_tpb, B)

    def decode_batch(self, loglikes) -> List[dict]:
        """loglikes [B, T, P] -> list of {words, alignment, total_cost}."""
        B = np.shape(loglikes)[0]
        if len(self.arcs.src) == 0:
            # no emitting arcs: with T >= 1 frames no path exists
            return [{"words": [], "alignment": [],
                     "total_cost": -NEG_INF, "final_reached": False}
                    for _ in range(B)]
        best, _, arcs_taken = self.arc_path(loglikes)
        best = best.cpu().numpy()
        arcs_taken = arcs_taken.cpu().numpy()                     # [T, B]
        A = len(self.arcs.src)
        # vectorized label lookup for the whole batch (a per-arc Python
        # loop costs more than the device scan at production B*T)
        oks = (best > NEG_INF / 2) & (arcs_taken < A).all(axis=0)
        safe = np.minimum(arcs_taken, A - 1)
        il = self.arcs.ilabel[safe]                               # [T, B]
        ol = self.arcs.olabel[safe]
        results = []
        for b in range(B):
            ok = bool(oks[b])
            words = ol[:, b][ol[:, b] > 0].tolist() if ok else []
            results.append({"words": words,
                            "alignment": il[:, b].tolist() if ok else [],
                            "total_cost": -float(best[b]),
                            "final_reached": ok})
        return results


class DeviceLatticeDecoder:
    """Exact beam-pruned lattice generation on the device for
    epsilon-free graphs; host assembly into decode.lattice.Lattice
    objects.  An arc instance (t, a) is kept iff

        alpha[t, src] + (graph_cost + scale*acoustic_cost) + beta[t+1, dst]
            <= best_total + lattice_beam

    which is Lattice.prune's keep criterion.  layout: as
    SparseViterbiDecoder's.

    `transfer='auto'` (default) compacts the packed keep-mask on the
    device (the nonzero bytes and their indices, `torch.nonzero`) when it
    holds more than AUTO_COMPACT_BYTES; 'dense' always ships the whole
    packed mask, 'compact' always compacts.  `compact_cap` bounds the
    nonzero bytes shipped; above it the dense transfer runs (on the
    device as well, with the same lattice)."""

    # compact the mask transfer above this many packed-mask bytes
    AUTO_COMPACT_BYTES = 1 << 22

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 lattice_beam: float = 8.0, layout: str = "auto", mesh=None,
                 transfer: str = "auto", compact_cap: int = 1 << 22,
                 device=None):
        self.layout = _segment_layout(layout, mesh)
        if transfer not in ("auto", "dense", "compact"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        self.lattice_beam = lattice_beam
        self.transfer = transfer
        self.compact_cap = int(compact_cap)
        # above this, the alpha history is checkpointed (rematerialized
        # forward; HCLG-scale lattices)
        self.alpha_hist_limit = 1 << 30
        self._g = _Arcs(self.arcs, acoustic_scale, self.device)
        self._beam = torch.tensor(lattice_beam, dtype=torch.float32,
                                  device=self.device)
        # set by each decode_batch: "dense", "compact" or
        # "compact-overflow" (compacted, over compact_cap, shipped dense),
        # and the nonzero mask bytes a compaction found (None: dense)
        self.last_transfer = None
        self.last_kept_bytes = None

    def masks(self, loglikes):
        """loglikes [B, T, P] -> (packed keep-masks [T, ceil(A/8), B]
        uint8, best [B]) on the device."""
        ll = _loglikes(loglikes, self.device)
        B, T, _ = ll.shape
        S = self.arcs.num_states
        ac_tpb = torch.neg(ll.permute(1, 2, 0).contiguous())  # [T, P, B]
        if T * S * B * 4 > self.alpha_hist_limit:
            chunk = _pick_chunk(T, S, B, self.alpha_hist_limit)
            return _lattice_masks_ckpt(self._g, ac_tpb, self._beam, B, chunk)
        return _lattice_masks(self._g, ac_tpb, self._beam, B)

    def decode_batch(self, loglikes, mark=None) -> List["object"]:
        """loglikes [B, T, P] -> list of Lattice (already beam-pruned).

        mark: called with a phase's name where it ends ("scans",
        "compact_sync", "compact", "assembly", "gather"; a name may come
        twice), e.g. a utils.profiling.PhaseClock."""
        from kaldi_fp16_tpu_torch.decode.lattice import ArcArrays, Lattice
        mark = mark or (lambda name: None)
        if len(self.arcs.src) == 0:
            return [Lattice(num_nodes=1, arcs=[],
                            final_cost=np.array([np.inf]),
                            node_frame=np.zeros(1, np.int64))
                    for _ in range(np.shape(loglikes)[0])]
        ll = _loglikes(loglikes, self.device)
        B, T, P = ll.shape
        packed, best = self.masks(ll)
        mark("scans")
        nbytes_row = int(packed.shape[1])
        use_compact = (self.transfer == "compact"
                       or (self.transfer == "auto"
                           and packed.numel() > self.AUTO_COMPACT_BYTES))
        sparse_by_b = None
        self.last_transfer, self.last_kept_bytes = "dense", None
        if use_compact:
            # kept bits are ~0.1-5% dense at real lattice beams: ship the
            # nonzero bytes and their flat indices, not the whole mask
            # (torch.count_nonzero would take 3.5 GB of scratch for a
            # 390 MB mask on an H100; nonzero 7 MB)
            flat = packed.view(-1)
            idx = torch.nonzero(flat).view(-1)
            mark("compact_sync")
            self.last_kept_bytes = int(idx.numel())
            self.last_transfer = "compact-overflow"
            if idx.numel() <= self.compact_cap:
                self.last_transfer = "compact"
                vals_h = flat[idx].cpu().numpy()
                idx_h = idx.cpu().numpy()
                bcol = idx_h % B
                rem = idx_h // B
                byts_all = rem % nbytes_row
                ts8_all = rem // nbytes_row
                sparse_by_b = [
                    (ts8_all[m], byts_all[m], vals_h[m])
                    for m in (bcol == b for b in range(B))]
        if sparse_by_b is None:
            packed = packed.cpu().numpy()               # [T, bits/8, B]
        mark("compact")
        a = self.arcs
        A = len(a.src)
        S = self.arcs.num_states
        # acoustic costs: with the compact transfer, gather ONLY the kept
        # arcs' loglikes on the device instead of downloading [B, T, P]
        lls = None if sparse_by_b is not None else ll.cpu().numpy()
        mark("gather")
        pending = []          # (ts, ais, uniq, inv) per b
        out = []
        for b in range(B):
            # vectorized assembly: node key = frame*S + state; np.unique
            # keys ascending, and in an exact lattice every frame-0
            # source is the start state (alpha[0] is finite only there),
            # so node 0 is always (0, start) as Lattice requires.  Only
            # the NONZERO mask bytes are unpacked.
            if sparse_by_b is not None:
                ts8, byts, nzvals = sparse_by_b[b]
            else:
                pb = packed[:, :, b]                    # [T, nbytes]
                ts8, byts = np.nonzero(pb)
                nzvals = pb[ts8, byts]
            bits = np.unpackbits(nzvals)                # MSB-first
            slots = (byts[:, None] * 8
                     + np.arange(8, dtype=byts.dtype)[None, :]).ravel()
            sel = (bits > 0) & (slots < A)
            ts = np.repeat(ts8, 8)[sel]
            ais = slots[sel]
            src_keys = ts.astype(np.int64) * S + a.src[ais]
            dst_keys = (ts.astype(np.int64) + 1) * S + a.dst[ais]
            start_key = np.asarray([0 * S + a.start], np.int64)
            uniq, inv = np.unique(
                np.concatenate([start_key, src_keys, dst_keys]),
                return_inverse=True)
            pending.append((ts, ais, uniq, inv))
        mark("assembly")

        if lls is None:
            # one batched device gather for every kept arc of every b
            counts = [len(p[0]) for p in pending]
            bb = np.repeat(np.arange(B, dtype=np.int64),
                           np.asarray(counts, np.int64))
            tt = (np.concatenate([p[0] for p in pending])
                  if pending else np.zeros(0, np.int64)).astype(np.int64)
            pp = a.pdf[np.concatenate([p[1] for p in pending])
                       if pending else np.zeros(0, np.int64)].astype(np.int64)
            if len(bb):
                ac_all = ll[torch.from_numpy(bb).to(self.device),
                            torch.from_numpy(tt).to(self.device),
                            torch.from_numpy(pp).to(self.device)] \
                    .cpu().numpy()
            else:
                ac_all = np.zeros(0, np.float32)
            splits = np.cumsum(counts)[:-1]
            ac_by_b = np.split(ac_all, splits)
        else:
            ac_by_b = [lls[b, p[0], a.pdf[p[1]]]
                       for b, p in enumerate(pending)]
        mark("gather")

        for b, (ts, ais, uniq, inv) in enumerate(pending):
            n = len(uniq)
            k = len(ts)
            src_ids = inv[1:1 + k]
            dst_ids = inv[1 + k:]
            frames = (uniq // S).astype(np.int64)
            arcs = ArcArrays(src_ids, dst_ids, a.ilabel[ais], a.olabel[ais],
                             (-a.weight[ais]).astype(np.float64),
                             (-ac_by_b[b]).astype(np.float64))
            final = np.full(n, np.inf)
            at_T = frames == T
            if at_T.any():
                fc = self.graph.final_cost[uniq[at_T] - T * S]
                final[at_T] = fc
            out.append(Lattice(num_nodes=n, arcs=arcs, final_cost=final,
                               node_frame=frames))
        mark("assembly")
        return out
