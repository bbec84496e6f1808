"""Lattice generation, pruning, and rescoring.

Kaldi-style lattices (lattice-faster-decoder semantics, reimplemented from
scratch): a time-synchronous DAG over (frame, graph-state) nodes whose arcs
keep GRAPH cost and ACOUSTIC cost separate, so the lattice can be rescored
with different acoustic scales / LM weights, or composed with a new
language model, WITHOUT re-running the acoustic model.

Pipeline:
  LatticeDecoder.decode(loglikes)       -> raw Lattice (all arcs surviving
                                           the decoding beam)
  lattice.prune(lattice_beam)           -> posterior-style pruning: keep
                                           arcs on paths within `beam` of
                                           the best (forward+arc+backward)
  lattice.best_path(acoustic_scale,
                    lm_scale)           -> re-Viterbi under new scales
  rescore_with_lm(lattice, lm, ...)     -> replace/augment word scores with
                                           an n-gram LM (on-the-fly
                                           composition over olabels)
  lattice.oracle_wer(ref)               -> lowest-WER path in the lattice

No counterpart exists in the reference repo (it never implemented
decoding); the design follows Kaldi's CompactLattice scale semantics.

Copy of kaldi_fp16_tpu/decode/lattice.py (the port imports nothing of
the JAX package); tests/test_torch_decode_host.py holds the two equal.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph


@dataclass
class LatticeArc:
    src: int             # lattice node id
    dst: int
    ilabel: int          # transition/pdf ilabel (0 = epsilon)
    olabel: int          # word (0 = epsilon)
    graph_cost: float
    acoustic_cost: float

    def cost(self, acoustic_scale: float = 1.0, lm_scale: float = 1.0
             ) -> float:
        return lm_scale * self.graph_cost + acoustic_scale * self.acoustic_cost


class ArcArrays:
    """Sequence of LatticeArc over parallel numpy arrays.  Same lazy-view
    pattern as io/native.py LazyIndexList: building millions of
    LatticeArc objects was the bottleneck of device-lattice assembly
    (docs/PERFORMANCE.md decode table), and the hot lattice algorithms
    (forward/backward costs, prune) only need the arrays."""

    __slots__ = ("src", "dst", "ilabel", "olabel", "graph_cost",
                 "acoustic_cost")

    def __init__(self, src, dst, ilabel, olabel, graph_cost, acoustic_cost):
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.ilabel = np.asarray(ilabel, np.int32)
        self.olabel = np.asarray(olabel, np.int32)
        self.graph_cost = np.asarray(graph_cost, np.float64)
        self.acoustic_cost = np.asarray(acoustic_cost, np.float64)

    @classmethod
    def from_arcs(cls, arcs) -> "ArcArrays":
        if isinstance(arcs, cls):
            return arcs
        return cls([a.src for a in arcs], [a.dst for a in arcs],
                   [a.ilabel for a in arcs], [a.olabel for a in arcs],
                   [a.graph_cost for a in arcs],
                   [a.acoustic_cost for a in arcs])

    def costs(self, acoustic_scale: float, lm_scale: float) -> np.ndarray:
        return (lm_scale * self.graph_cost
                + acoustic_scale * self.acoustic_cost)

    def __len__(self) -> int:
        return len(self.src)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return LatticeArc(int(self.src[i]), int(self.dst[i]),
                          int(self.ilabel[i]), int(self.olabel[i]),
                          float(self.graph_cost[i]),
                          float(self.acoustic_cost[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self) -> bool:
        return len(self.src) > 0


@dataclass
class Lattice:
    """Nodes are topologically ordered (by frame).  Node 0 is the start;
    `final_cost[n]` is +inf for non-final nodes.  `arcs` may be a list of
    LatticeArc or an ArcArrays view (the device decoders build the
    latter; both support the full Sequence API)."""
    num_nodes: int
    arcs: List[LatticeArc]
    final_cost: np.ndarray          # [num_nodes]
    node_frame: np.ndarray          # [num_nodes] frame index of each node

    def _arc_arrays(self) -> ArcArrays:
        # cache keyed on the arcs object itself (held strongly, compared
        # with `is`, so a garbage-collected list can never alias a new one
        # the way an id() key could): reassigning/replacing lat.arcs
        # invalidates it (mutating a LIST of arcs in place after first use
        # is still unsupported — arcs are treated as frozen once
        # algorithms have run, like every array field here)
        cached = getattr(self, "_aa", None)
        if cached is not None and cached[0] is self.arcs:
            return cached[1]
        aa = ArcArrays.from_arcs(self.arcs)
        object.__setattr__(self, "_aa", (self.arcs, aa))
        return aa

    def _is_eps_free(self) -> bool:
        aa = self._arc_arrays()
        return bool((self.node_frame[aa.dst] > self.node_frame[aa.src]).all())

    def _frame_groups(self):
        """(order, bounds) grouping arcs by source frame — shared by the
        vectorized forward/backward/prune so the argsort runs once."""
        cached = getattr(self, "_fg", None)
        aa = self._arc_arrays()
        if cached is not None and cached[0] is aa:
            return cached[1], cached[2]
        src_frame = self.node_frame[aa.src]
        order = np.argsort(src_frame, kind="stable")
        hi = int(src_frame.max()) + 2 if len(order) else 1
        bounds = np.searchsorted(src_frame[order], np.arange(hi))
        object.__setattr__(self, "_fg", (aa, order, bounds))
        return order, bounds

    # -- shortest path under given scales ------------------------------------

    def _arc_topo_order(self) -> List[int]:
        """Arc indices in a topological order of the node DAG (same-frame
        epsilon chains make frame order alone insufficient)."""
        out: Dict[int, List[int]] = {}
        indeg = np.zeros(self.num_nodes, np.int64)
        for i, a in enumerate(self.arcs):
            out.setdefault(a.src, []).append(i)
            indeg[a.dst] += 1
        order: List[int] = []
        stack = [n for n in range(self.num_nodes) if indeg[n] == 0]
        while stack:
            n = stack.pop()
            for i in out.get(n, ()):
                order.append(i)
                d = self.arcs[i].dst
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(d)
        if len(order) != len(self.arcs):       # cycle fallback (shouldn't)
            order = sorted(range(len(self.arcs)),
                           key=lambda i: self.node_frame[self.arcs[i].src])
        return order

    def _forward_costs(self, acoustic_scale: float, lm_scale: float
                       ) -> Tuple[np.ndarray, List[Optional[LatticeArc]]]:
        if self._is_eps_free():
            alpha, back_idx = self._forward_costs_vec(acoustic_scale,
                                                      lm_scale)
            aa = self._arc_arrays()
            # LatticeArc views materialize lazily, and only for nodes
            # actually reached (back_idx >= 0)
            back = [None if i < 0 else aa[int(i)] for i in back_idx]
            return alpha, back
        alpha = np.full(self.num_nodes, np.inf)
        alpha[0] = 0.0
        back: List[Optional[LatticeArc]] = [None] * self.num_nodes
        for i in self._arc_topo_order():
            a = self.arcs[i]
            c = alpha[a.src] + a.cost(acoustic_scale, lm_scale)
            if c < alpha[a.dst]:
                alpha[a.dst] = c
                back[a.dst] = a
        return alpha, back

    def _forward_costs_vec(self, acoustic_scale: float, lm_scale: float,
                           cost: Optional[np.ndarray] = None,
                           with_back: bool = True
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Frame-synchronous vectorized forward (eps-free lattices): arcs
        grouped by source frame, per-frame scatter-min.  Returns
        (alpha, best-incoming-arc-index per node, -1 = none).  Matches
        the scalar path's semantics: only FINITE candidates set back
        pointers, first-in-arc-order wins ties."""
        aa = self._arc_arrays()
        if cost is None:
            cost = aa.costs(acoustic_scale, lm_scale)
        alpha = np.full(self.num_nodes, np.inf)
        alpha[0] = 0.0
        back_idx = np.full(self.num_nodes, -1, np.int64) if with_back \
            else None
        order, bounds = self._frame_groups()
        for f in range(len(bounds) - 1):
            idx = order[bounds[f]:bounds[f + 1]]
            if not len(idx):
                continue
            cand = alpha[aa.src[idx]] + cost[idx]
            np.minimum.at(alpha, aa.dst[idx], cand)
            if with_back:
                win = (cand == alpha[aa.dst[idx]]) & np.isfinite(cand)
                # reversed write order => the FIRST tying arc (in arc
                # order; `order` is a stable sort) lands last and wins,
                # matching the scalar path's strict-< behavior
                wsel = np.nonzero(win)[0][::-1]
                back_idx[aa.dst[idx[wsel]]] = idx[wsel]
        return alpha, back_idx

    def _backward_costs(self, acoustic_scale: float, lm_scale: float,
                        cost: Optional[np.ndarray] = None) -> np.ndarray:
        if self._is_eps_free():
            aa = self._arc_arrays()
            if cost is None:
                cost = aa.costs(acoustic_scale, lm_scale)
            beta = np.array(self.final_cost, dtype=np.float64)
            order, bounds = self._frame_groups()
            for f in range(len(bounds) - 2, -1, -1):
                idx = order[bounds[f]:bounds[f + 1]]
                if not len(idx):
                    continue
                np.minimum.at(beta, aa.src[idx],
                              cost[idx] + beta[aa.dst[idx]])
            return beta
        beta = np.array(self.final_cost, dtype=np.float64)
        for i in reversed(self._arc_topo_order()):
            a = self.arcs[i]
            c = a.cost(acoustic_scale, lm_scale) + beta[a.dst]
            if c < beta[a.src]:
                beta[a.src] = c
        return beta

    def best_path(self, acoustic_scale: float = 1.0, lm_scale: float = 1.0
                  ) -> Tuple[List[int], float]:
        """Viterbi over the lattice under the given scales.
        Returns (words, total_cost)."""
        alpha, back = self._forward_costs(acoustic_scale, lm_scale)
        total = alpha + self.final_cost
        end = int(np.argmin(total))
        words: List[int] = []
        node = end
        while back[node] is not None:
            a = back[node]
            if a.olabel > 0:
                words.append(a.olabel)
            node = a.src
        words.reverse()
        return words, float(total[end])

    def prune(self, lattice_beam: float, acoustic_scale: float = 1.0,
              lm_scale: float = 1.0) -> "Lattice":
        """Keep arcs on paths within lattice_beam of the best path
        (forward + arc + backward pruning, Kaldi PruneLattice)."""
        aa = self._arc_arrays()
        if self._is_eps_free():
            # alpha only (no back-pointer materialization) + one shared
            # cost vector across forward/backward/mask
            cost = aa.costs(acoustic_scale, lm_scale)
            alpha, _ = self._forward_costs_vec(acoustic_scale, lm_scale,
                                               cost=cost, with_back=False)
            beta = self._backward_costs(acoustic_scale, lm_scale,
                                        cost=cost)
        else:
            cost = aa.costs(acoustic_scale, lm_scale)
            alpha, _ = self._forward_costs(acoustic_scale, lm_scale)
            beta = self._backward_costs(acoustic_scale, lm_scale)
        best = float(np.min(alpha + self.final_cost))
        if not np.isfinite(best):
            return self  # no reachable final state: nothing to prune against
        mask = (alpha[aa.src] + cost + beta[aa.dst]) <= \
            best + lattice_beam + 1e-6
        return _renumber_arrays(self, aa, mask)

    # -- n-best / oracle ------------------------------------------------------

    def n_best(self, n: int, acoustic_scale: float = 1.0,
               lm_scale: float = 1.0) -> List[Tuple[List[int], float]]:
        """N shortest word sequences (unique), by A*-ish path enumeration."""
        beta = self._backward_costs(acoustic_scale, lm_scale)
        out_arcs: Dict[int, List[LatticeArc]] = {}
        for a in self.arcs:
            out_arcs.setdefault(a.src, []).append(a)
        results: List[Tuple[List[int], float]] = []
        seen = set()
        DONE = -1  # terminal marker: hypothesis complete at `cost`
        heap = [(float(beta[0]), 0.0, 0, ())]
        iters = 0
        while heap and len(results) < n and iters < 100000:
            iters += 1
            est, cost, node, words = heapq.heappop(heap)
            if node == DONE:
                key = tuple(words)
                if key not in seen:
                    seen.add(key)
                    results.append((list(words), cost))
                continue
            fc = self.final_cost[node]
            if np.isfinite(fc):
                # finishing here competes on the heap with continuations
                # (emitting immediately would misorder vs cheaper paths)
                fcost = cost + float(fc)
                heapq.heappush(heap, (fcost, fcost, DONE, words))
            for a in out_arcs.get(node, ()):
                c = cost + a.cost(acoustic_scale, lm_scale)
                w = words + (a.olabel,) if a.olabel > 0 else words
                heapq.heappush(heap, (c + float(beta[a.dst]), c, a.dst, w))
        return results

    def oracle_wer(self, ref: Sequence[int], acoustic_scale: float = 1.0,
                   lm_scale: float = 1.0, n: int = 64) -> Tuple[float, List[int]]:
        """Lowest WER over the n-best paths (lattice oracle estimate)."""
        from kaldi_fp16_tpu_torch.decode.wer import levenshtein
        best = (np.inf, [])
        for words, _ in self.n_best(n, acoustic_scale, lm_scale):
            edits = levenshtein(list(ref), words)[3]
            rate = edits / max(1, len(ref))
            if rate < best[0]:
                best = (rate, words)
        return best

    def word_sequences(self) -> set:
        """All distinct word sequences (for small test lattices)."""
        return {tuple(w) for w, _ in self.n_best(1000)}

    def arc_posteriors(self, acoustic_scale: float = 1.0,
                       lm_scale: float = 1.0) -> np.ndarray:
        """Per-arc posterior probability under the log semiring:
        gamma[a] = exp(alpha[src] + logp(a) + beta[dst] - total), with
        alpha/beta log-sum forward/backward over the lattice (the
        sum-over-paths analog of _forward/_backward_costs' min-plus).
        For an eps-free lattice the posteriors of the arcs leaving any
        frame cut sum to 1 (tested).  Kaldi analog: the gamma of
        lattice-arc-post / confidence tooling."""
        aa = self._arc_arrays()
        lp = -aa.costs(acoustic_scale, lm_scale)      # log path score
        alpha = np.full(self.num_nodes, -np.inf)
        alpha[0] = 0.0
        beta = np.where(np.isfinite(self.final_cost),
                        -self.final_cost.astype(np.float64), -np.inf)
        if self._is_eps_free():
            order, bounds = self._frame_groups()
            for f in range(len(bounds) - 1):
                idx = order[bounds[f]:bounds[f + 1]]
                if len(idx):
                    np.logaddexp.at(alpha, aa.dst[idx],
                                    alpha[aa.src[idx]] + lp[idx])
            for f in range(len(bounds) - 2, -1, -1):
                idx = order[bounds[f]:bounds[f + 1]]
                if len(idx):
                    np.logaddexp.at(beta, aa.src[idx],
                                    lp[idx] + beta[aa.dst[idx]])
        else:
            topo = self._arc_topo_order()
            for i in topo:
                a = self.arcs[i]
                alpha[a.dst] = np.logaddexp(
                    alpha[a.dst],
                    alpha[a.src] - a.cost(acoustic_scale, lm_scale))
            for i in reversed(topo):
                a = self.arcs[i]
                beta[a.src] = np.logaddexp(
                    beta[a.src],
                    -a.cost(acoustic_scale, lm_scale) + beta[a.dst])
        # total over paths = logsumexp of alpha at final nodes
        fin = np.isfinite(self.final_cost)
        if not fin.any():
            return np.zeros(len(aa))
        total = np.logaddexp.reduce(
            alpha[fin] - self.final_cost[fin].astype(np.float64))
        with np.errstate(invalid="ignore"):
            g = alpha[aa.src] + lp + beta[aa.dst] - total
        return np.where(np.isfinite(g), np.exp(np.minimum(g, 0.0)), 0.0)

    def to_ctm(self, frame_shift: float = 0.03,
               acoustic_scale: float = 1.0, lm_scale: float = 1.0,
               with_confidence: bool = True
               ) -> List[Tuple[float, float, int, float]]:
        """Best path as CTM rows (start_s, dur_s, word_id, confidence).

        Word timing: a word starts at its emitting arc's source frame
        and runs until the next word's start (last word: to the final
        frame) — the standard approximation without word-boundary info
        (Kaldi nbest-to-ctm on a word-aligned lattice is exact; HCLG
        olabel placement makes this approximate either way).
        Confidence: total posterior mass of arcs carrying the same
        word label that overlap the word's frame span (a lightweight
        lattice-confidence analog, not full MBR)."""
        alpha, back = self._forward_costs(acoustic_scale, lm_scale)
        total = alpha + self.final_cost
        end = int(np.argmin(total))
        if not np.isfinite(total[end]):
            return []
        path: List[LatticeArc] = []
        node = end
        while back[node] is not None:
            path.append(back[node])
            node = back[node].src
        path.reverse()
        T_end = int(self.node_frame[end])
        starts = [(int(self.node_frame[a.src]), a.olabel)
                  for a in path if a.olabel > 0]
        gamma = self.arc_posteriors(acoustic_scale, lm_scale) \
            if with_confidence else None
        aa = self._arc_arrays() if with_confidence else None
        rows = []
        for i, (f0, w) in enumerate(starts):
            f1 = starts[i + 1][0] if i + 1 < len(starts) else max(T_end, f0 + 1)
            f1 = max(f1, f0 + 1)
            conf = 1.0
            if with_confidence:
                sel = ((aa.olabel == w)
                       & (self.node_frame[aa.src] < f1)
                       & (self.node_frame[aa.dst] > f0))
                conf = float(min(1.0, gamma[sel].sum()))
            rows.append((round(f0 * frame_shift, 3),
                         round((f1 - f0) * frame_shift, 3), int(w), conf))
        return rows


def _renumber_arrays(lat: Lattice, aa: ArcArrays,
                     mask: np.ndarray) -> Lattice:
    """Vectorized renumber of the kept-arc subset (node 0 preserved)."""
    src = aa.src[mask]
    dst = aa.dst[mask]
    used = np.unique(np.concatenate([[0], src, dst]))
    remap = np.full(lat.num_nodes, -1, np.int64)
    remap[used] = np.arange(len(used))
    arcs = ArcArrays(remap[src], remap[dst], aa.ilabel[mask],
                     aa.olabel[mask], aa.graph_cost[mask],
                     aa.acoustic_cost[mask])
    return Lattice(num_nodes=len(used), arcs=arcs,
                   final_cost=lat.final_cost[used],
                   node_frame=lat.node_frame[used])


def _renumber(lat: Lattice, arcs: List[LatticeArc]) -> Lattice:
    used = {0}
    for a in arcs:
        used.add(a.src)
        used.add(a.dst)
    order = sorted(used)
    remap = {old: i for i, old in enumerate(order)}
    new_arcs = [LatticeArc(remap[a.src], remap[a.dst], a.ilabel, a.olabel,
                           a.graph_cost, a.acoustic_cost) for a in arcs]
    return Lattice(num_nodes=len(order), arcs=new_arcs,
                   final_cost=lat.final_cost[order],
                   node_frame=lat.node_frame[order])


# ---------------------------------------------------------------------------
# Lattice-generating decoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LatticeDecodeOptions:
    beam: float = 16.0
    lattice_beam: float = 8.0
    max_active: int = 7000
    acoustic_scale: float = 1.0


class LatticeDecoder:
    """Token-passing beam search that records ALL surviving arcs into a
    lattice (per-state best token for pruning decisions, all incoming arcs
    within the beam kept as lattice arcs — lattice-faster-decoder shape)."""

    def __init__(self, graph: DecodingGraph,
                 opts: LatticeDecodeOptions = LatticeDecodeOptions()):
        self.graph = graph
        self.opts = opts

    def decode(self, loglikes: np.ndarray) -> Lattice:
        g = self.graph
        opts = self.opts
        T = loglikes.shape[0]

        # lattice node = (frame, graph_state); node ids assigned on demand
        node_of: Dict[Tuple[int, int], int] = {}
        node_frames: List[int] = []

        def node(frame: int, state: int) -> int:
            key = (frame, state)
            nid = node_of.get(key)
            if nid is None:
                nid = len(node_of)
                node_of[key] = nid
                node_frames.append(frame)
            return nid

        arcs: List[LatticeArc] = []
        start_node = node(0, g.start)
        costs: Dict[int, float] = {g.start: 0.0}

        def eps_expand(frame: int, costs: Dict[int, float]):
            heap = [(c, s) for s, c in costs.items()]
            heapq.heapify(heap)
            while heap:
                c, s = heapq.heappop(heap)
                if c > costs.get(s, np.inf) + 1e-12:
                    continue
                for a in range(g.eps_row_ptr[s], g.eps_row_ptr[s + 1]):
                    d = int(g.eps_dst[a])
                    w = float(g.eps_weight[a])
                    nc = c + w
                    if nc < costs.get(d, np.inf) - 1e-12:
                        costs[d] = nc
                        heapq.heappush(heap, (nc, d))
                        arcs.append(LatticeArc(node(frame, s), node(frame, d),
                                               0, int(g.eps_olabel[a]), w, 0.0))

        eps_expand(0, costs)

        for t in range(T):
            frame = loglikes[t]
            best = min(costs.values())
            cutoff = best + opts.beam
            if len(costs) > opts.max_active:
                cut2 = sorted(costs.values())[opts.max_active - 1]
                cutoff = min(cutoff, cut2)
            nxt: Dict[int, float] = {}
            for s, c in costs.items():
                if c > cutoff:
                    continue
                for a in range(g.em_row_ptr[s], g.em_row_ptr[s + 1]):
                    il = int(g.em_ilabel[a])
                    # lattice arcs keep the UNscaled acoustic cost so
                    # rescoring scales are not compounded with the decode
                    # scale; the token-passing beam uses the decode scale
                    ac = -float(frame[g.pdf_of(il)])
                    gc = float(g.em_weight[a])
                    d = int(g.em_dst[a])
                    nc = c + gc + opts.acoustic_scale * ac
                    if nc < nxt.get(d, np.inf):
                        nxt[d] = nc
                    arcs.append(LatticeArc(node(t, s), node(t + 1, d),
                                           il, int(g.em_olabel[a]), gc, ac))
            eps_expand(t + 1, nxt)
            # prune token set (the lattice keeps already-recorded arcs;
            # final pruning happens in Lattice.prune)
            if nxt:
                b = min(nxt.values())
                nxt = {s: c for s, c in nxt.items() if c <= b + opts.beam}
            costs = nxt
            if not costs:
                break

        n_nodes = len(node_of)
        final = np.full(n_nodes, np.inf)
        for (frame, state), nid in node_of.items():
            if frame == T:
                fc = g.final_cost[state]
                if np.isfinite(fc):
                    final[nid] = float(fc)
        lat = Lattice(num_nodes=n_nodes, arcs=arcs, final_cost=final,
                      node_frame=np.asarray(node_frames))
        # drop arcs that cannot reach a final node, and apply lattice beam
        return lat.prune(opts.lattice_beam, opts.acoustic_scale, 1.0)


# ---------------------------------------------------------------------------
# LM rescoring
# ---------------------------------------------------------------------------

class NGramLM:
    """Tiny backoff n-gram LM over word ids (costs are -log probs).

    `ngrams` maps tuples (w1, ..., wk) -> cost of wk given the k-1 prefix;
    `backoffs` maps context tuples -> backoff cost.  Missing mass falls
    through to shorter contexts (standard Katz-style lookup).  Suitable for
    lattice rescoring tests and small vocabularies; an ARPA file can be
    loaded into the same dicts."""

    def __init__(self, ngrams: Dict[tuple, float],
                 backoffs: Optional[Dict[tuple, float]] = None,
                 order: int = 2, oov_cost: float = 20.0):
        self.ngrams = dict(ngrams)
        self.backoffs = dict(backoffs or {})
        self.order = order
        self.oov_cost = oov_cost

    def cost(self, context: tuple, word: int) -> float:
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        bo_total = 0.0
        while True:
            key = context + (word,)
            if key in self.ngrams:
                return bo_total + self.ngrams[key]
            if not context:
                return bo_total + self.oov_cost
            bo_total += self.backoffs.get(context, 0.0)
            context = context[1:]


def rescore_with_lm(lat: Lattice, lm: NGramLM, lm_weight: float = 1.0,
                    old_lm_weight: float = 0.0,
                    eos: Optional[int] = None) -> Lattice:
    """Compose the lattice with an n-gram LM over output labels.

    Expands lattice nodes into (node, lm_context) pairs; each word arc's
    graph cost becomes  old_lm_weight * graph_cost + lm_weight * lm_cost
    (old_lm_weight=0 replaces the graph LM scores entirely, =1 adds).
    Acoustic costs are untouched — that is the point of keeping them
    separate (Kaldi lmrescore).

    `eos`: optional end-of-sentence symbol.  When given, each final node
    additionally pays lm_weight * lm.cost(ctx, eos) in its final cost —
    the </s> probability that G.fst's final weights carry in Kaldi
    lmrescore.  Without it the sentence-final LM mass is dropped whenever
    old_lm_weight == 0; callers that pre-fold </s> into sentence costs
    should leave it None."""
    out_arcs: Dict[int, List[LatticeArc]] = {}
    for a in lat.arcs:
        out_arcs.setdefault(a.src, []).append(a)

    # BFS over (node, context)
    new_nodes: Dict[Tuple[int, tuple], int] = {}
    new_frames: List[int] = []
    new_final: List[float] = []

    def get(node: int, ctx: tuple) -> int:
        key = (node, ctx)
        nid = new_nodes.get(key)
        if nid is None:
            nid = len(new_nodes)
            new_nodes[key] = nid
            new_frames.append(int(lat.node_frame[node]))
            fc = float(lat.final_cost[node])
            if eos is not None and np.isfinite(fc):
                fc += lm_weight * lm.cost(ctx, eos)
            new_final.append(fc)
        return nid

    new_arc_list: List[LatticeArc] = []
    stack = [(0, ())]
    seen = {(0, ())}
    get(0, ())
    while stack:
        node, ctx = stack.pop()
        src_id = new_nodes[(node, ctx)]
        for a in out_arcs.get(node, ()):
            if a.olabel > 0:
                lm_cost = lm.cost(ctx, a.olabel)
                gc = old_lm_weight * a.graph_cost + lm_weight * lm_cost
                nctx = (ctx + (a.olabel,))[-(lm.order - 1):] if lm.order > 1 else ()
            else:
                gc = old_lm_weight * a.graph_cost
                nctx = ctx
            dst_id = get(a.dst, nctx)
            new_arc_list.append(LatticeArc(src_id, dst_id, a.ilabel,
                                           a.olabel, gc, a.acoustic_cost))
            if (a.dst, nctx) not in seen:
                seen.add((a.dst, nctx))
                stack.append((a.dst, nctx))

    return Lattice(num_nodes=len(new_nodes), arcs=new_arc_list,
                   final_cost=np.asarray(new_final),
                   node_frame=np.asarray(new_frames))
