"""Batched exact decoding on the device: dense and arc-parallel Viterbi,
and exact beam-pruned lattices.

The torch counterpart of kaldi_fp16_tpu/decode/tpu_viterbi.py:

  * `DenseViterbiDecoder`: the max-plus recursion over a dense [S, S]
    transition table, one frame at a time, traceback on the device;
  * `SparseViterbiDecoder`: arcs as a flat list sorted by destination
    (`ArcGraph`; the arc ids of that order are the backpointers), scores
    state-major [S, B], per frame

        cand = (score[src] + w) + scale * ll[pdf]          # [A, B]
        nxt  = max of cand into dst                        # [S, B]
        bp   = smallest arc id reaching nxt                # [S, B]

    with the traceback on the device, so only [T, B] int32 arc ids leave
    it; above `bp_hist_limit` bytes of backpointers the forward keeps
    scores at chunk starts only and the traceback recomputes each chunk;
  * `DeviceLatticeDecoder`: a min-plus alpha scan and a reverse beta scan
    that emits the bit-packed keep-mask of the arcs within the lattice
    beam; checkpointed alphas above `alpha_hist_limit`; the mask ships
    dense or compacted on the device, and the host assembles `Lattice`
    objects (decode/lattice.py).

Three layouts reduce the candidates into states, each a frame-step object
with the same calls (`viterbi_step`, `alpha_step`, `beta_step`), so one
set of frame loops (`_viterbi_frames`, `_traceback`, `_arc_viterbi[_ckpt]`,
`_lattice_masks[_ckpt]`) serves all three:

  * "segment" (`_Arcs`, the default, "auto"): `scatter_reduce_` with
    "amax" / "amin" into a tensor filled with the reduction's identity;
    no arc enters a state: backpointer int32 max;
  * "ell" (`_Ell`, `EllGraph`): each state's in-arcs (out-arcs for beta)
    padded into degree buckets of power-of-two width, an axis max / min
    per bucket, the bucket outputs un-permuted by one gather; no
    checkpointed Viterbi, and its lattices refuse a history above
    `alpha_hist_limit`, as in the JAX package;
  * "tree" (`_Tree`, `TreeEllGraph`): rows capped at `tree_max_width`
    slots and reduce levels until one row per state; the lattice keep-mask
    comes out in the OUT tree's level-1 slot order and the host maps it
    to arc ids.

Max and min do not depend on the order of their operands, so a decode
repeats bit for bit; ties go to the smallest arc id in every layout
(`torch.argmax` returns the first maximum, and rows hold a state's arcs
in ascending id order).  ELL and tree mark "no arc" with A.  `mesh`, a
parallel.mesh.DataGroup, decodes each rank's B / world rows on its own
device and gives every rank the outputs of all rows (`_Rows`).  The
streaming decoders (decode/streaming.py) run `_viterbi_frames` and
`_traceback` chunk by chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Tuple

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


@dataclass
class EllGraph:
    """Degree-bucketed padded adjacency of an ArcGraph.

    Each bucket b holds the states whose degree rounds up to the same
    power of two D_b, as [S_b, D_b] tables.  `src` entries are ORIGINAL
    state ids (scores stay in original numbering; only the concatenated
    bucket OUTPUT is permuted, undone by the `new_of_old` gather).  `arc`
    entries are ArcGraph arc indices (len(arcs) == pad sentinel).
    Padding: src=0, pdf=0, weight=NEG_INF (max-plus: never wins)."""
    src: Tuple[np.ndarray, ...]     # [S_b, D_b] int32 each
    pdf: Tuple[np.ndarray, ...]
    weight: Tuple[np.ndarray, ...]  # max-plus (-cost), NEG_INF pad
    arc: Tuple[np.ndarray, ...]
    new_of_old: np.ndarray          # [S] int32: orig state -> bucket row
    num_states: int
    num_arcs: int

    @classmethod
    def from_arcs(cls, a: ArcGraph, direction: str = "in") -> "EllGraph":
        """direction='in': rows are destination states, `src` holds arc
        sources (forward/Viterbi).  direction='out': rows are source
        states, `src` holds arc destinations (beta recursion)."""
        A = len(a.src)
        S = a.num_states
        if A == 0:
            # states and no emitting arc: one all-pad bucket, nothing
            # ever wins a max
            return cls(src=(np.zeros((S, 1), np.int32),),
                       pdf=(np.zeros((S, 1), np.int32),),
                       weight=(np.full((S, 1), NEG_INF, np.float32),),
                       arc=(np.zeros((S, 1), np.int32),),
                       new_of_old=np.arange(S, dtype=np.int32),
                       num_states=S, num_arcs=0)
        if direction == "in":
            order = np.arange(A, dtype=np.int64)   # already dst-sorted
            key, other = a.dst, a.src
        else:
            order = np.argsort(a.src, kind="stable").astype(np.int64)
            key, other = a.src[order], a.dst[order]
        deg = np.bincount(key, minlength=S).astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(deg)])
        d_of = np.where(deg <= 1, 1,
                        2 ** np.ceil(np.log2(np.maximum(deg, 1))
                                     ).astype(np.int64))
        srcs, pdfs, ws, arcs = [], [], [], []
        state_order = []
        for D in sorted(set(d_of.tolist())):
            st = np.nonzero(d_of == D)[0]
            state_order.append(st)
            idx = row_ptr[st][:, None] + np.arange(D)[None, :]
            valid = np.arange(D)[None, :] < deg[st][:, None]
            pos = order[np.minimum(idx, max(A - 1, 0))]   # ArcGraph index
            srcs.append(np.where(valid, other[np.minimum(idx, max(A - 1, 0))],
                                 0).astype(np.int32))
            pdfs.append(np.where(valid, a.pdf[pos], 0).astype(np.int32))
            ws.append(np.where(valid, a.weight[pos],
                               NEG_INF).astype(np.float32))
            arcs.append(np.where(valid, pos, A).astype(np.int32))
        perm = np.concatenate(state_order) if state_order else \
            np.zeros(0, np.int64)
        new_of_old = np.empty(S, np.int32)
        new_of_old[perm] = np.arange(S, dtype=np.int32)
        return cls(src=tuple(srcs), pdf=tuple(pdfs), weight=tuple(ws),
                   arc=tuple(arcs), new_of_old=new_of_old,
                   num_states=S, num_arcs=A)

    def to(self, device) -> "EllGraph":
        """The tables as tensors on `device`: int64 indices, float32
        weights."""
        return replace(self, src=_idx(self.src, device),
                       pdf=_idx(self.pdf, device),
                       weight=_f32(self.weight, device),
                       arc=_idx(self.arc, device),
                       new_of_old=_idx(self.new_of_old, device))


@dataclass
class TreeEllGraph:
    """Capped-width padded adjacency with reduction levels.

    Level 1: width-bucketed [R_b, W_b] tables over ARC slots (src state
    to gather scores from, pdf, max-plus weight, ArcGraph arc id; pads:
    src=0, pdf=0, weight=NEG_INF, arc=A).  `levels`: per reduce level, a
    tuple of width-bucketed [R_b, W_b] int32 tables whose entries index
    the PREVIOUS level's concatenated row outputs (pad = R_prev, which
    gathers a sentinel row appended at compute time).  The final level
    has exactly one row per state, in state order.

    `row_state`: per level-1 bucket, the [R_b] OWNING state of each row
    (the reduction target: dst for direction='in', src for 'out'); the
    lattice keep-mask gathers alpha at it once per row instead of once
    per arc (`_Tree.beta_step`)."""
    src: Tuple[np.ndarray, ...]
    pdf: Tuple[np.ndarray, ...]
    weight: Tuple[np.ndarray, ...]
    arc: Tuple[np.ndarray, ...]
    levels: Tuple[Tuple[np.ndarray, ...], ...]
    num_states: int
    num_arcs: int
    max_width: int
    row_state: Tuple[np.ndarray, ...] = ()

    @classmethod
    def from_arcs(cls, a: ArcGraph, direction: str = "in",
                  max_width: int = 128) -> "TreeEllGraph":
        A = len(a.src)
        S = a.num_states
        W = max(int(max_width), 2)
        if A == 0:
            return cls(src=(np.zeros((S, 1), np.int32),),
                       pdf=(np.zeros((S, 1), np.int32),),
                       weight=(np.full((S, 1), NEG_INF, np.float32),),
                       arc=(np.zeros((S, 1), np.int32),),
                       levels=(), num_states=S, num_arcs=0, max_width=W,
                       row_state=(np.arange(S, dtype=np.int32),))
        if direction == "in":
            order = np.arange(A, dtype=np.int64)   # already dst-sorted
            key, other = a.dst, a.src
        else:
            order = np.argsort(a.src, kind="stable").astype(np.int64)
            key, other = a.src[order], a.dst[order]
        deg = np.bincount(key, minlength=S).astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(deg)])

        def split_rows(counts, item_ptr):
            """Chunk each state's contiguous item run into rows of <= W.
            Returns (row_state, row_rank, row_start, row_len); every
            state gets >= 1 row (a zero-length all-pad row if empty)."""
            r = np.maximum((counts + W - 1) // W, 1)
            R = int(r.sum())
            rs = np.repeat(np.arange(S, dtype=np.int64), r)
            rk = np.arange(R, dtype=np.int64) - np.repeat(
                np.cumsum(r) - r, r)
            start = item_ptr[rs] + rk * W
            length = np.clip(counts[rs] - rk * W, 0, W)
            return rs, rk, start, length

        def bucket_tables(start, length, fill):
            """Width-bucket rows (stable: row order preserved within a
            bucket) and build padded slot tables via
            `fill(slots, valid, rows)`.  Returns
            (tables_per_bucket, out_order_of_rows)."""
            width = np.where(length <= 1, 1,
                             2 ** np.ceil(np.log2(np.maximum(length, 1))
                                          ).astype(np.int64))
            out_order = np.argsort(width, kind="stable").astype(np.int64)
            tables = []
            for D in sorted(set(width.tolist())):
                rows = out_order[width[out_order] == D]
                slots = start[rows][:, None] + np.arange(D)[None, :]
                valid = np.arange(D)[None, :] < length[rows][:, None]
                tables.append(fill(slots, valid, rows))
            return tables, out_order

        # ---- level 1: arc slots ----------------------------------------
        rs, rk, start, length = split_rows(deg, row_ptr)
        srcs, pdfs, ws, arcs, rstates = [], [], [], [], []

        def fill_l1(slots, valid, rows):
            safe = np.minimum(slots, max(A - 1, 0))
            pos = order[safe]
            srcs.append(np.where(valid, other[safe], 0).astype(np.int32))
            pdfs.append(np.where(valid, a.pdf[pos], 0).astype(np.int32))
            ws.append(np.where(valid, a.weight[pos],
                               NEG_INF).astype(np.float32))
            arcs.append(np.where(valid, pos, A).astype(np.int32))
            rstates.append(rs[rows].astype(np.int32))
            return None

        _, out_order = bucket_tables(start, length, fill_l1)
        state_out = rs[out_order]      # state of each concatenated out row
        rank_out = rk[out_order]       # ascending-arc chunk index in state
        R_prev = len(state_out)

        # ---- reduce levels: until one state-ordered row per state ------
        levels = []
        while not (R_prev == S
                   and np.array_equal(state_out, np.arange(S))):
            item_order = np.lexsort((rank_out, state_out))  # state-major
            counts = np.bincount(state_out, minlength=S).astype(np.int64)
            iptr = np.concatenate([[0], np.cumsum(counts)])
            rs, rk, start, length = split_rows(counts, iptr)
            entries = []

            def fill_lvl(slots, valid, rows, _entries=entries,
                         _item_order=item_order, _R=R_prev):
                safe = np.minimum(slots, max(_R - 1, 0))
                _entries.append(np.where(valid, _item_order[safe],
                                         _R).astype(np.int32))
                return None

            _, out_order = bucket_tables(start, length, fill_lvl)
            levels.append(tuple(entries))
            state_out = rs[out_order]
            rank_out = rk[out_order]
            R_prev = len(state_out)

        return cls(src=tuple(srcs), pdf=tuple(pdfs), weight=tuple(ws),
                   arc=tuple(arcs), levels=tuple(levels),
                   num_states=S, num_arcs=A, max_width=W,
                   row_state=tuple(rstates))

    def to(self, device) -> "TreeEllGraph":
        """The tables as tensors on `device`: int64 indices, float32
        weights."""
        return replace(self, src=_idx(self.src, device),
                       pdf=_idx(self.pdf, device),
                       weight=_f32(self.weight, device),
                       arc=_idx(self.arc, device),
                       levels=tuple(_idx(lvl, device)
                                    for lvl in self.levels),
                       row_state=_idx(self.row_state, device))


def _idx(x, device):
    """int64 tensor(s) on `device` of an array or a tuple of arrays."""
    if isinstance(x, tuple):
        return tuple(_idx(v, device) for v in x)
    return torch.from_numpy(np.asarray(x, np.int64)).to(device)


def _f32(xs, device):
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 for x in xs)


LAYOUTS = ("segment", "ell", "tree")


def _layout(layout: str) -> str:
    """'auto' is the segment layout at every scale: the JAX package's
    auto takes the tree above 64K arcs because of the TPU's scatter."""
    if layout == "auto":
        return "segment"
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    return layout


def _same_device(a: torch.device, b: torch.device) -> bool:
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(torch.device(a)) == norm(torch.device(b))


class _Rows:
    """This rank's rows of a [B, ...] batch under a data group (`mesh`,
    parallel.mesh.DataGroup; None: every row), and the all-reduce that
    gives every rank the [.., B] outputs of all rows.  Each rank writes
    its columns into zeros, so every column has one contributor and the
    sum is exact; float32 outputs travel as their bit patterns in an
    integer tensor (`join`), so one call carries a decode's outputs."""

    def __init__(self, mesh, device):
        from kaldi_fp16_tpu_torch.parallel.mesh import DataGroup
        if mesh is not None:
            if not isinstance(mesh, DataGroup):
                raise TypeError(f"mesh must be a parallel.mesh.DataGroup, "
                                f"got {type(mesh).__name__}")
            if not _same_device(mesh.device, device):
                raise ValueError(f"mesh {mesh} is on {mesh.device}, the "
                                 f"decoder on {device}")
        self.group = mesh

    def span(self, B: int):
        """(first, end) of this rank's rows of a batch of B."""
        if self.group is None:
            return 0, B
        n = self.group.world
        if B % n:
            raise ValueError(f"batch {B} not divisible by data-axis size "
                             f"{n}")
        b = B // n
        return self.group.rank * b, (self.group.rank + 1) * b

    def join(self, B: int, *parts):
        """Local [.., b] int32 / float32 / uint8 tensors -> the same with
        all B columns on every rank (unchanged without a mesh)."""
        if self.group is None:
            return parts
        r0, r1 = self.span(B)
        dtype = torch.uint8 if any(p.dtype == torch.uint8 for p in parts) \
            else torch.int32
        # [.., B] layout of each part in one flat buffer; float32 and int32
        # parts are viewed as 4 bytes each when the buffer is uint8
        shapes = [p.shape[:-1] + (B,) for p in parts]
        width = [4 if (dtype == torch.uint8 and p.dtype != torch.uint8)
                 else 1 for p in parts]
        sizes = [math.prod(s) * w for s, w in zip(shapes, width)]
        # 4-byte parts first, so their views stay aligned
        order = sorted(range(len(parts)), key=lambda i: -width[i])
        buf = torch.zeros(sum(sizes), dtype=dtype, device=parts[0].device)
        views, off = [None] * len(parts), 0
        for i in order:
            seg = buf[off:off + sizes[i]]
            off += sizes[i]
            p = parts[i]
            if dtype == torch.uint8 and p.dtype != torch.uint8:
                seg = seg.view(p.dtype)
            elif dtype == torch.int32 and p.dtype == torch.float32:
                seg = seg.view(torch.float32)
            views[i] = seg.view(shapes[i])
            views[i][..., r0:r1] = p
        self.group.all_reduce(buf)
        return tuple(views)


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
    """An ArcGraph's arrays on the device and the segment layout's frame
    steps over them.  `_Ell` and `_Tree` keep these arrays (the traceback
    reads `src`, the ELL keep test the arc rows) and replace the steps.
    `nbits` is the length of a frame's keep-mask before packing."""

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
        self.nbits = self.A
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
        self.pack(keep, packed_out)
        return beta

    def pack(self, keep, packed_out):
        """keep [8 * nbytes, B] bool -> packed_out [nbytes, B] uint8, the
        first of each 8 rows in the byte's top bit."""
        bits = keep.view(torch.uint8).view(-1, 8, keep.shape[1])
        torch.sum(bits * self.bit_weights[None, :, None], 1,
                  dtype=torch.uint8, out=packed_out)


def _flat(x, B: int, cols):
    """Flat indices [..., B] of the rows x of a row-major [rows, B]
    tensor, for torch.take."""
    return x[..., None] * B + cols


class _EllTables:
    """One direction of an EllGraph on the device, and the flat take
    indices of its tables for the last batch size."""

    def __init__(self, e: EllGraph, device):
        d = e.to(device)
        self.src, self.pdf = d.src, d.pdf
        self.w = tuple(x[:, :, None] for x in d.weight)
        self.negw = tuple((-x)[:, :, None] for x in d.weight)
        self.arc = tuple(x.to(torch.int32) for x in d.arc)
        self.perm = d.new_of_old
        self.S = e.num_states
        self._B = None

    def rows(self, B: int):
        if self._B != B:
            cols = torch.arange(B, device=self.perm.device)
            self._rows = ([_flat(x, B, cols) for x in self.src],
                          [_flat(x, B, cols) for x in self.pdf],
                          _flat(self.perm, B, cols))
            self._B = B
        return self._rows

    def min_step(self, x, ac_t, scale, out=None):
        """Min-plus reduction of (x[src] + (-w)) + scale * ac[pdf] into
        the row states, un-permuted, at most INF."""
        B = x.shape[1]
        src_rows, pdf_rows, perm_rows = self.rows(B)
        vals = torch.empty((self.S, B), device=x.device)
        r0 = 0
        for sr, pr, negw in zip(src_rows, pdf_rows, self.negw):
            r1 = r0 + sr.shape[0]
            cand = torch.take(x, sr).add_(negw)
            cand += scale * torch.take(ac_t, pr)
            torch.amin(cand, 1, out=vals[r0:r1])
            r0 = r1
        return torch.take(vals, perm_rows, out=out).clamp_max_(INF)


class _Ell(_Arcs):
    """The ELL layout's frame steps (tpu_viterbi.py's _ell_viterbi and
    _lattice_masks_ell): per degree bucket, gathers and an axis max / min,
    then one gather by `new_of_old` puts the states back in order."""

    def __init__(self, a: ArcGraph, acoustic_scale: float,
                 device: torch.device, lattice: bool = False):
        super().__init__(a, acoustic_scale, device)
        self.fin = _EllTables(EllGraph.from_arcs(a, "in"), device)
        self.fout = (_EllTables(EllGraph.from_arcs(a, "out"), device)
                     if lattice else None)

    def viterbi_step(self, score, ll_t, bp_out=None):
        """As _Arcs.viterbi_step, A where no arc enters the state; no
        clamp of the scores (the JAX kernel has none)."""
        t = self.fin
        B = score.shape[1]
        src_rows, pdf_rows, perm_rows = t.rows(B)
        vals = torch.empty((self.S, B), device=score.device)
        arcs = (torch.empty((self.S, B), dtype=torch.int32,
                            device=score.device)
                if bp_out is not None else None)
        r0 = 0
        for sr, pr, w, arc in zip(src_rows, pdf_rows, t.w, t.arc):
            r1 = r0 + sr.shape[0]
            cand = torch.take(score, sr).add_(w)
            cand += self.scale * torch.take(ll_t, pr)
            torch.amax(cand, 1, out=vals[r0:r1])
            if arcs is not None:
                torch.gather(arc, 1, cand.argmax(1), out=arcs[r0:r1])
            r0 = r1
        if arcs is not None:
            torch.take(arcs, perm_rows, out=bp_out)
        return torch.take(vals, perm_rows)

    def alpha_step(self, alpha, ac_t, out):
        return self.fin.min_step(alpha, ac_t, self.scale, out)

    def beta_step(self, beta_next, alpha_t, ac_t, thr, keep, packed_out):
        """Beta on the OUT tables; the keep test per arc in arc order,
        (alpha[src] + cost) + beta[dst] <= thr."""
        beta = self.fout.min_step(beta_next, ac_t, self.scale)
        src_rows, dst_rows, _ = self.rows(beta_next.shape[1])
        tot = torch.take(alpha_t, src_rows) + self.arc_costs(ac_t)
        tot += torch.take(beta_next, dst_rows)
        torch.le(tot, thr[None, :], out=keep[:self.A])
        self.pack(keep, packed_out)
        return beta


class _TreeTables:
    """One direction of a TreeEllGraph on the device, and the flat take
    indices of its tables for the last batch size.  `sizes[k]`: the rows
    each stage (level 1, then the reduce levels) outputs."""

    def __init__(self, t: TreeEllGraph, device, row_rows: bool = False):
        d = t.to(device)
        self.src, self.pdf = d.src, d.pdf
        self.w = tuple(x[:, :, None] for x in d.weight)
        self.negw = tuple((-x)[:, :, None] for x in d.weight)
        self.arc = tuple(x.to(torch.int32) for x in d.arc)
        self.levels = d.levels
        self.row_state = d.row_state
        self.sizes = [sum(x.shape[0] for x in d.src)] + [
            sum(x.shape[0] for x in lvl) for lvl in d.levels]
        self.slots = [x.shape[0] * x.shape[1] for x in d.src]
        self.with_row_rows = row_rows
        self._B = None

    def rows(self, B: int):
        if self._B != B:
            cols = torch.arange(B, device=self.row_state[0].device)
            self._rows = (
                [_flat(x, B, cols) for x in self.src],
                [_flat(x, B, cols) for x in self.pdf],
                [_flat(x, B, cols) for x in self.row_state]
                if self.with_row_rows else None,
                # a one-wide bucket gathers its rows straight: [R_b, B]
                [[_flat(x[:, 0] if x.shape[1] == 1 else x, B, cols)
                  for x in lvl] for lvl in self.levels])
            self._B = B
        return self._rows

    def stage(self, k: int, B: int, like, sentinel, out=None):
        """Stage k's output buffer: `out` (or a new [S, B]) for the last
        stage, else its rows plus the sentinel row the next level's pads
        gather."""
        R = self.sizes[k]
        if k == len(self.sizes) - 1:
            return out if out is not None else like.new_empty((R, B))
        buf = like.new_empty((R + 1, B))
        buf[R].fill_(sentinel)
        return buf

    def min_step(self, x, ac_t, scale, out=None):
        """Min-plus reduction of (x[src] + (-w)) + scale * ac[pdf] into
        the states, at most INF."""
        B = x.shape[1]
        src_rows, pdf_rows, _, _ = self.rows(B)
        vals = self.stage(0, B, x, INF, out)
        r0 = 0
        for sr, pr, negw in zip(src_rows, pdf_rows, self.negw):
            r1 = r0 + sr.shape[0]
            cand = torch.take(x, sr).add_(negw)
            cand += scale * torch.take(ac_t, pr)
            torch.amin(cand, 1, out=vals[r0:r1])
            r0 = r1
        return self.min_levels(vals, B, out)

    def min_levels(self, vals, B: int, out=None):
        """The reduce levels' min over the level-1 outputs `vals`."""
        lvl_rows = self.rows(B)[3]
        for k, (lvl, rows) in enumerate(zip(self.levels, lvl_rows), 1):
            prev, vals = vals, self.stage(k, B, vals, INF, out)
            r0 = 0
            for idx, rr in zip(lvl, rows):
                r1 = r0 + idx.shape[0]
                if idx.shape[1] == 1:
                    torch.take(prev, rr, out=vals[r0:r1])
                else:
                    torch.amin(torch.take(prev, rr), 1, out=vals[r0:r1])
                r0 = r1
        return vals.clamp_max_(INF)


class _Tree(_Arcs):
    """The tree-ELL layout's frame steps (tpu_viterbi.py's
    _tree_max_step, _tree_min_step, _tree_min_step_mask): level-1 buckets
    of at most `max_width` arc slots, then reduce levels over the previous
    level's outputs, a sentinel row appended for their pads, until one row
    per state in state order.  With `lattice`, the OUT tables too: the
    keep-mask comes in their level-1 slot order (`nbits` slots,
    `slot_arc` maps a slot to its arc id, A for a pad)."""

    def __init__(self, a: ArcGraph, acoustic_scale: float,
                 device: torch.device, max_width: int = 128,
                 lattice: bool = False):
        super().__init__(a, acoustic_scale, device)
        self.fin = _TreeTables(TreeEllGraph.from_arcs(a, "in", max_width),
                               device)
        self.fout = None
        if lattice:
            tog = TreeEllGraph.from_arcs(a, "out", max_width)
            self.fout = _TreeTables(tog, device, row_rows=True)
            self.slot_arc = np.concatenate([x.reshape(-1) for x in tog.arc])
            self.nbits = len(self.slot_arc)

    def viterbi_step(self, score, ll_t, bp_out=None):
        """As _Arcs.viterbi_step, A where no arc enters the state; the
        scores at least NEG_INF."""
        t = self.fin
        B = score.shape[1]
        src_rows, pdf_rows, _, lvl_rows = t.rows(B)
        track = bp_out is not None
        vals = t.stage(0, B, score, NEG_INF)
        arcs = t.stage(0, B, bp_out, self.A, bp_out) if track else None
        r0 = 0
        for sr, pr, w, arc in zip(src_rows, pdf_rows, t.w, t.arc):
            r1 = r0 + sr.shape[0]
            cand = torch.take(score, sr).add_(w)
            cand += self.scale * torch.take(ll_t, pr)
            torch.amax(cand, 1, out=vals[r0:r1])
            if track:
                torch.gather(arc, 1, cand.argmax(1), out=arcs[r0:r1])
            r0 = r1
        for k, (lvl, rows) in enumerate(zip(t.levels, lvl_rows), 1):
            prev_v, vals = vals, t.stage(k, B, vals, NEG_INF)
            if track:
                prev_a, arcs = arcs, t.stage(k, B, arcs, self.A, bp_out)
            r0 = 0
            for idx, rr in zip(lvl, rows):
                r1 = r0 + idx.shape[0]
                if idx.shape[1] == 1:
                    torch.take(prev_v, rr, out=vals[r0:r1])
                    if track:
                        torch.take(prev_a, rr, out=arcs[r0:r1])
                else:
                    g = torch.take(prev_v, rr)
                    torch.amax(g, 1, out=vals[r0:r1])
                    if track:
                        # the winner's row of the previous level, then
                        # its arc id in this column
                        sel = torch.gather(idx, 1, g.argmax(1))
                        torch.gather(prev_a, 0, sel, out=arcs[r0:r1])
                r0 = r1
        return vals.clamp_min_(NEG_INF)

    def alpha_step(self, alpha, ac_t, out):
        return self.fin.min_step(alpha, ac_t, self.scale, out)

    def beta_step(self, beta_next, alpha_t, ac_t, thr, keep, packed_out):
        """Beta on the OUT tables; the keep test per level-1 slot,
        alpha[row_state] + ((beta[dst] + (-w)) + scale * ac) <= thr, in
        slot order."""
        t = self.fout
        B = beta_next.shape[1]
        dst_rows, pdf_rows, row_rows, _ = t.rows(B)
        vals = t.stage(0, B, beta_next, INF)
        r0 = s0 = 0
        for dr, pr, rr, negw, n in zip(dst_rows, pdf_rows, row_rows,
                                       t.negw, t.slots):
            r1, s1 = r0 + dr.shape[0], s0 + n
            cand = torch.take(beta_next, dr).add_(negw)
            cand += self.scale * torch.take(ac_t, pr)
            torch.amin(cand, 1, out=vals[r0:r1])
            tot = torch.take(alpha_t, rr)[:, None, :] + cand
            torch.le(tot, thr, out=keep[s0:s1].view(cand.shape))
            r0, s0 = r1, s1
        self.pack(keep, packed_out)
        return t.min_levels(vals, B)


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
    [T, ceil(nbits/8), B] uint8, best [B]), with the alpha history
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
    nbytes = -(-g.nbits // 8)
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


def _frame_steps(layout: str, arcs: ArcGraph, acoustic_scale: float,
                 device, tree_max_width: int, lattice: bool = False):
    """The frame-step object of a layout ('segment', 'ell', 'tree')."""
    if layout == "tree":
        return _Tree(arcs, acoustic_scale, device, tree_max_width, lattice)
    if layout == "ell":
        return _Ell(arcs, acoustic_scale, device, lattice)
    return _Arcs(arcs, acoustic_scale, device)


class SparseViterbiDecoder:
    """Exact batched Viterbi over an epsilon-free graph, arc-parallel on
    the device with on-device traceback (the same results as
    DenseViterbiDecoder).

    layout: 'auto' and 'segment' select the segment layout, 'ell' and
    'tree' (rows of at most `tree_max_width` slots) theirs; every layout
    gives the segment layout's words, alignment and cost.  'ell' keeps
    the whole backpointer table at any size (no checkpointed path, as in
    the JAX package); the others checkpoint above `bp_hist_limit`.

    mesh: a parallel.mesh.DataGroup on this decoder's device: each rank
    decodes its B / world rows (B must divide) and one all-reduce gives
    every rank the results of all B rows."""

    def __init__(self, graph: DecodingGraph, acoustic_scale: float = 1.0,
                 layout: str = "auto", mesh=None, tree_max_width: int = 128,
                 device=None):
        self.layout = _layout(layout)
        self.device = resolve_device(device)
        self._rows = _Rows(mesh, self.device)
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        # above this, decode_batch switches to the checkpointed-score
        # path (no [T, S, B] backpointer table; big batches on
        # HCLG-scale graphs)
        self.bp_hist_limit = 1 << 30
        self._g = _frame_steps(self.layout, self.arcs, acoustic_scale,
                               self.device, tree_max_width)

    def arc_path(self, loglikes):
        """loglikes [B, T, P] -> (best [B], last [B], arcs_taken [T, B]
        int32), on the device; a graph with no emitting arc has none."""
        ll = _loglikes(loglikes, self.device)
        B, T, _ = ll.shape
        r0, r1 = self._rows.span(B)
        b = r1 - r0
        ll_tpb = ll[r0:r1].permute(1, 2, 0).contiguous()        # [T, P, b]
        S = self.arcs.num_states
        if self.layout != "ell" and T * S * b * 4 > self.bp_hist_limit:
            # HCLG scale: the [T, S, B] backpointer table would not fit;
            # checkpoint scores and rematerialize per chunk
            chunk = _pick_chunk(T, S, b, self.bp_hist_limit)
            best, last, arcs = _arc_viterbi_ckpt(self._g, ll_tpb, b, chunk)
        else:
            best, last, arcs = _arc_viterbi(self._g, ll_tpb, b)
        if self._rows.group is None:
            return best, last, arcs
        best, last, arcs = self._rows.join(B, best, last.to(torch.int32),
                                           arcs)
        return best, last.long(), arcs

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

    which is Lattice.prune's keep criterion.  layout, tree_max_width
    and mesh: as SparseViterbiDecoder's; the lattices' arc sets are the
    segment layout's.  'ell' keeps the whole alpha history and raises
    ValueError above `alpha_hist_limit` (as the JAX package does); the
    others checkpoint alpha there.  The tree layout's mask comes in its
    OUT tables' slot order, and the host maps slots to arc ids.

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
                 tree_max_width: int = 128, transfer: str = "auto",
                 compact_cap: int = 1 << 22, device=None):
        self.layout = _layout(layout)
        if transfer not in ("auto", "dense", "compact"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.device = resolve_device(device)
        self._rows = _Rows(mesh, self.device)
        self.graph = graph
        self.arcs = ArcGraph.from_graph(graph)
        self.acoustic_scale = acoustic_scale
        self.lattice_beam = lattice_beam
        self.transfer = transfer
        self.compact_cap = int(compact_cap)
        # above this, the alpha history is checkpointed (rematerialized
        # forward; HCLG-scale lattices)
        self.alpha_hist_limit = 1 << 30
        self._g = _frame_steps(self.layout, self.arcs, acoustic_scale,
                               self.device, tree_max_width, lattice=True)
        self._beam = torch.tensor(lattice_beam, dtype=torch.float32,
                                  device=self.device)
        # set by each decode_batch: "dense", "compact" or
        # "compact-overflow" (compacted, over compact_cap, shipped dense),
        # and the nonzero mask bytes a compaction found (None: dense)
        self.last_transfer = None
        self.last_kept_bytes = None

    def masks(self, loglikes):
        """loglikes [B, T, P] -> (packed keep-masks [T, ceil(nbits/8), B]
        uint8, best [B]) on the device; nbits is A but for the tree
        layout, whose bits are its OUT tables' slots."""
        ll = _loglikes(loglikes, self.device)
        B, T, _ = ll.shape
        r0, r1 = self._rows.span(B)
        b = r1 - r0
        S = self.arcs.num_states
        ac_tpb = torch.neg(ll[r0:r1].permute(1, 2, 0).contiguous())
        hist_bytes = T * S * b * 4
        if self.layout == "ell" and hist_bytes > self.alpha_hist_limit:
            raise ValueError(
                f"layout='ell' keeps the full alpha history ([T={T}, S={S}, "
                f"B={b}] = {hist_bytes / 2**30:.1f} GiB > alpha_hist_limit "
                f"{self.alpha_hist_limit / 2**30:.1f} GiB); use "
                f"layout='segment' or 'tree' (they checkpoint alpha at this "
                f"scale) or shrink the batch or graph")
        if hist_bytes > self.alpha_hist_limit:
            chunk = _pick_chunk(T, S, b, self.alpha_hist_limit)
            packed, best = _lattice_masks_ckpt(self._g, ac_tpb, self._beam,
                                               b, chunk)
        else:
            packed, best = _lattice_masks(self._g, ac_tpb, self._beam, b)
        return self._rows.join(B, packed, best)

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
        nbits = self._g.nbits
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
            sel = (bits > 0) & (slots < nbits)
            ts = np.repeat(ts8, 8)[sel]
            ais = slots[sel]
            if self.layout == "tree":
                # slots -> arc ids (a pad slot never fires: its cost is
                # 1e30), then the (t, arc) order of the other layouts
                ais = self._g.slot_arc[ais]
                live = ais < A
                ts, ais = ts[live], ais[live]
                o = np.lexsort((ais, ts))
                ts, ais = ts[o], ais[o]
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
