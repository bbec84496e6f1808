"""Decoding graph: HCLG transducer in SoA form for beam search.

Arcs are split into emitting (ilabel > 0; consumes one acoustic frame) and
epsilon (ilabel == 0) groups per state, pre-sorted for the decoder.
ilabel conventions: by default ilabel-1 indexes the acoustic log-likelihood
row (pdf-id); an optional ilabel_to_pdf map handles transition-id graphs.

Copy of kaldi_fp16_tpu/decode/graph.py (the port imports nothing of
the JAX package); tests/test_torch_decode_host.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from kaldi_fp16_tpu_torch.io.fst import Fst, read_fst_file


@dataclass
class DecodingGraph:
    num_states: int
    start: int
    # emitting arcs, CSR by source state
    em_row_ptr: np.ndarray     # [S+1]
    em_dst: np.ndarray         # [E]
    em_ilabel: np.ndarray      # [E] (>0)
    em_olabel: np.ndarray      # [E]
    em_weight: np.ndarray      # [E] tropical (cost)
    # epsilon arcs, CSR by source state
    eps_row_ptr: np.ndarray
    eps_dst: np.ndarray
    eps_olabel: np.ndarray
    eps_weight: np.ndarray
    final_cost: np.ndarray     # [S], +inf if not final
    ilabel_to_pdf: Optional[np.ndarray] = None  # [max_ilabel+1]

    def pdf_of(self, ilabel: int) -> int:
        if self.ilabel_to_pdf is not None:
            return int(self.ilabel_to_pdf[ilabel])
        return ilabel - 1

    @classmethod
    def from_fst(cls, fst: Fst,
                 ilabel_to_pdf: Optional[np.ndarray] = None) -> "DecodingGraph":
        S = fst.num_states
        em_rp = [0]
        eps_rp = [0]
        em_dst, em_il, em_ol, em_w = [], [], [], []
        eps_dst, eps_ol, eps_w = [], [], []
        final = np.full(S, np.inf, dtype=np.float64)
        for s, st in enumerate(fst.states):
            for a in st.arcs:
                if a.label > 0:
                    em_dst.append(a.next_state)
                    em_il.append(a.label)
                    em_ol.append(a.olabel)
                    em_w.append(a.weight)
                else:
                    eps_dst.append(a.next_state)
                    eps_ol.append(a.olabel)
                    eps_w.append(a.weight)
            em_rp.append(len(em_dst))
            eps_rp.append(len(eps_dst))
            if st.is_final:
                final[s] = st.final
        return cls(
            num_states=S, start=fst.start,
            em_row_ptr=np.asarray(em_rp, np.int64),
            em_dst=np.asarray(em_dst, np.int32),
            em_ilabel=np.asarray(em_il, np.int32),
            em_olabel=np.asarray(em_ol, np.int32),
            em_weight=np.asarray(em_w, np.float64),
            eps_row_ptr=np.asarray(eps_rp, np.int64),
            eps_dst=np.asarray(eps_dst, np.int32),
            eps_olabel=np.asarray(eps_ol, np.int32),
            eps_weight=np.asarray(eps_w, np.float64),
            final_cost=final,
            ilabel_to_pdf=ilabel_to_pdf,
        )

    @classmethod
    def from_arrays(cls, num_states: int, start: int,
                    src: np.ndarray, dst: np.ndarray, ilabel: np.ndarray,
                    olabel: np.ndarray, weight: np.ndarray,
                    final_cost: np.ndarray,
                    ilabel_to_pdf: Optional[np.ndarray] = None
                    ) -> "DecodingGraph":
        """Vectorized construction from flat arc arrays (no Python
        per-arc objects — required at HCLG scale, where 100K+ states /
        400K+ arcs make the Fst-object path minutes-slow)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int32)
        ilabel = np.asarray(ilabel, np.int32)
        olabel = np.asarray(olabel, np.int32)
        weight = np.asarray(weight, np.float64)
        S = int(num_states)

        def csr(mask):
            order = np.argsort(src[mask], kind="stable")
            rp = np.zeros(S + 1, np.int64)
            np.add.at(rp, src[mask] + 1, 1)
            return np.cumsum(rp), order

        em = ilabel > 0
        ep = ~em
        em_rp, em_o = csr(em)
        eps_rp, eps_o = csr(ep)
        return cls(
            num_states=S, start=int(start),
            em_row_ptr=em_rp,
            em_dst=dst[em][em_o], em_ilabel=ilabel[em][em_o],
            em_olabel=olabel[em][em_o], em_weight=weight[em][em_o],
            eps_row_ptr=eps_rp,
            eps_dst=dst[ep][eps_o], eps_olabel=olabel[ep][eps_o],
            eps_weight=weight[ep][eps_o],
            final_cost=np.asarray(final_cost, np.float64),
            ilabel_to_pdf=ilabel_to_pdf,
        )

    @classmethod
    def from_file(cls, path: str, **kw) -> "DecodingGraph":
        fst = read_fst_file(path)
        if fst is None:
            raise ValueError(f"cannot read FST {path}")
        return cls.from_fst(fst, **kw)


def remove_epsilons(g: DecodingGraph, method: str = "auto"
                    ) -> DecodingGraph:
    """Epsilon-removed equivalent graph for the on-device decoders.

    method: 'vector' (flat-array iterated min-plus closure — the
    HCLG-scale path), 'scalar' (per-state Dijkstra reference), 'auto'
    (vector above 2000 states).  Identical semantics; equal-cost eps
    routes share one deterministic tie-break in BOTH methods — smaller
    folded olabel wins, then the label-preserving route — so the folded
    graph does not change as a function of graph size.  (Exact-float
    ties only: costs differing by sub-1e-12 summation noise can still
    pick either route.)

    Real HCLG graphs carry epsilon (ilabel 0) arcs; the arc-parallel
    device decoders (decode/device_viterbi.py) need every arc to consume a
    frame.  Closure: per state, tropical shortest epsilon-distance to
    every eps-reachable state (Dijkstra over the eps subgraph), then

      * emitting arcs: (s -> d, il, w) exists iff s ->eps*-> u ->em-> d;
        new weight = dist(s, u) + w, best (min-cost) arc kept per
        (dst, ilabel, olabel) with the winning eps route's olabel folded
        in when the emitting arc's own olabel is 0 (HCLG pushes word
        labels, so eps arcs rarely carry them).
      * finals: final'(s) = min_u dist(s, u) + final(u).

    Exact for best-path/Viterbi COSTS (tropical semiring).  Word labels
    are preserved except in three constructions a pushed graph avoids:
    a winning eps route with >1 labeled eps arc, a labeled eps route
    into an emitting arc that has its OWN olabel, and a labeled eps
    route directly into a final state.  Each surviving-arc/final
    occurrence is counted (per the WINNING route, not tentative
    relaxations) and warned once.
    """
    import heapq

    # Dijkstra is only correct for non-negative arc weights; weight-pushed
    # HCLG graphs can carry negative epsilon weights, which would yield
    # silently non-shortest closure distances (wrong arc/final costs).
    # Fail loudly instead.
    if len(g.eps_weight) and float(np.min(g.eps_weight)) < 0.0:
        raise ValueError(
            "remove_epsilons: negative epsilon arc weight "
            f"({float(np.min(g.eps_weight)):.6g}); Dijkstra closure would "
            "be silently wrong. Push weights to non-negative epsilon arcs "
            "first (e.g. fstpushspecial) or remove epsilons upstream.")

    if method not in ("auto", "vector", "scalar"):
        raise ValueError(f"remove_epsilons: unknown method {method!r} "
                         "(use 'auto', 'vector' or 'scalar')")
    if method == "vector" or (method == "auto" and g.num_states > 2000):
        return _remove_epsilons_vector(g)

    S = g.num_states
    out_eps: List[List[int]] = [[] for _ in range(S)]
    for s in range(S):
        for a in range(g.eps_row_ptr[s], g.eps_row_ptr[s + 1]):
            out_eps[s].append(a)

    em_rp = [0]
    em_dst: List[int] = []
    em_il: List[int] = []
    em_ol: List[int] = []
    em_w: List[float] = []
    final = np.array(g.final_cost, dtype=np.float64)
    dropped = 0

    for s in range(S):
        # eps closure from s: dist + the WINNING route's first olabel and
        # a flag for labels already lost along that route (flags follow
        # the relaxation that wins, so they describe final routes only)
        dist = {s: 0.0}
        olab = {s: 0}
        lost = {s: False}
        heap = [(0.0, s)]
        while heap:
            c, u = heapq.heappop(heap)
            if c > dist.get(u, np.inf) + 1e-12:
                continue
            for a in out_eps[u]:
                d = int(g.eps_dst[a])
                nc = c + float(g.eps_weight[a])
                o = olab[u]
                eo = int(g.eps_olabel[a])
                cand = (o if o else eo, lost[u] or bool(o and eo))
                cur = dist.get(d, np.inf)
                if nc < cur - 1e-12:
                    dist[d] = nc
                    olab[d], lost[d] = cand
                    heapq.heappush(heap, (nc, d))
                elif nc < cur + 1e-12 and cand < (olab[d], lost[d]):
                    # equal-cost tie: shared deterministic tie-break
                    # with the vector path — smaller folded olabel,
                    # then the label-preserving route; re-push so the
                    # winning labels propagate downstream (terminates:
                    # (olab, lost) strictly decreases per update)
                    olab[d], lost[d] = cand
                    heapq.heappush(heap, (nc, d))
        best: Dict[tuple, tuple] = {}
        for u, du in dist.items():
            fc = du + float(g.final_cost[u])
            if fc < final[s]:
                final[s] = fc
                if olab[u] or lost[u]:
                    dropped += 1    # labeled eps route into a final state
            for a in range(g.em_row_ptr[u], g.em_row_ptr[u + 1]):
                d = int(g.em_dst[a])
                il = int(g.em_ilabel[a])
                own = int(g.em_olabel[a])
                ol = own or olab[u]
                w = du + float(g.em_weight[a])
                loses = lost[u] or bool(own and olab[u])
                key = (d, il, ol)
                if key not in best or w < best[key][0]:
                    best[key] = (w, il, ol, d, loses)
        for w, il, ol, d, loses in sorted(best.values(), key=lambda t: t[3]):
            em_dst.append(d)
            em_il.append(il)
            em_ol.append(ol)
            em_w.append(w)
            if loses:
                dropped += 1
        em_rp.append(len(em_dst))

    if dropped:
        import sys
        print(f"warning: remove_epsilons lost word labels on {dropped} "
              "surviving arcs/finals (multi-label eps routes or labeled "
              "eps into labeled/final arcs; costs stay exact — push "
              "labels in the graph build to avoid this)",
              file=sys.stderr)
    return DecodingGraph(
        num_states=S, start=g.start,
        em_row_ptr=np.asarray(em_rp, np.int64),
        em_dst=np.asarray(em_dst, np.int32),
        em_ilabel=np.asarray(em_il, np.int32),
        em_olabel=np.asarray(em_ol, np.int32),
        em_weight=np.asarray(em_w, np.float64),
        eps_row_ptr=np.zeros(S + 1, np.int64),
        eps_dst=np.empty(0, np.int32),
        eps_olabel=np.empty(0, np.int32),
        eps_weight=np.empty(0, np.float64),
        final_cost=final,
        ilabel_to_pdf=g.ilabel_to_pdf,
    )


def _remove_epsilons_vector(g: DecodingGraph,
                            max_pairs: int = 50_000_000,
                            max_iters: int = 1000) -> DecodingGraph:
    """Flat-array epsilon removal (same semantics as the scalar path).

    Closure by iterated min-plus relaxation: the (src, dst) -> (dist,
    route-olabel, labels-lost) pair set starts as the eps arcs and is
    repeatedly extended one eps arc (frontier joined against the arc
    list via searchsorted range-expansion) until no pair's distance
    improves.  HCLG eps routes are shallow, so this converges in a few
    rounds; every step is vectorized numpy — no per-state Python.
    """
    S = g.num_states
    es = np.repeat(np.arange(S, dtype=np.int64),
                   np.diff(g.eps_row_ptr).astype(np.int64))
    ed = g.eps_dst.astype(np.int64)
    ew = g.eps_weight.astype(np.float64)
    eo = g.eps_olabel.astype(np.int64)

    def dedup_pairs(s, u, w, o, l):
        """Best (min-dist) entry per (s, u); equal-dist ties prefer the
        smaller folded olabel, then the label-preserving route (the
        same deterministic tie-break as the scalar Dijkstra path)."""
        key = s * S + u
        order = np.lexsort((l, o, w, key))
        ks = key[order]
        first = np.ones(len(ks), bool)
        if len(ks) > 1:
            first[1:] = ks[1:] != ks[:-1]
        idx = order[first]
        return s[idx], u[idx], w[idx], o[idx], l[idx]

    # arcs grouped by source for the frontier join
    aord = np.argsort(es, kind="stable")
    a_src_sorted = es[aord]
    a_dst = ed[aord]
    a_w = ew[aord]
    a_o = eo[aord]

    if len(es):
        cs, cu, cw, co, cl = dedup_pairs(
            es, ed, ew, eo, np.zeros(len(es), bool))
    else:
        cs = cu = np.empty(0, np.int64)
        cw = np.empty(0, np.float64)
        co = np.empty(0, np.int64)
        cl = np.empty(0, bool)
    frontier = (cs, cu, cw, co, cl)

    for _ in range(max_iters):
        fs, fu, fw, fo, fl = frontier
        if not len(fs):
            break
        lo = np.searchsorted(a_src_sorted, fu, "left")
        hi = np.searchsorted(a_src_sorted, fu, "right")
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            break
        rep = np.repeat(np.arange(len(fs)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ai = np.repeat(lo, cnt) + within
        ns = fs[rep]
        nu = a_dst[ai]
        nw = fw[rep] + a_w[ai]
        keep_o = fo[rep]
        no = np.where(keep_o != 0, keep_o, a_o[ai])
        nl = fl[rep] | ((keep_o != 0) & (a_o[ai] != 0))

        # merge and find strictly-improved pairs (they form the next
        # frontier; equal-dist candidates terminate zero-weight cycles)
        old_key = cs * S + cu
        oorder = np.argsort(old_key)
        ok_sorted = old_key[oorder]
        nkey = ns * S + nu
        pos = np.searchsorted(ok_sorted, nkey)
        have = (pos < len(ok_sorted))
        safe = np.minimum(pos, max(len(ok_sorted) - 1, 0))
        known = have & (ok_sorted[safe] == nkey) if len(ok_sorted) else \
            np.zeros(len(nkey), bool)
        old_w = np.full(len(nkey), np.inf)
        old_o = np.full(len(nkey), np.iinfo(np.int64).max)
        old_l = np.ones(len(nkey), bool)
        if len(ok_sorted):
            old_w[known] = cw[oorder][safe[known]]
            old_o[known] = co[oorder][safe[known]]
            old_l[known] = cl[oorder][safe[known]]
        # strictly shorter, OR equal-cost with a preferred label fold
        # (shared tie-break with the scalar path: smaller olabel, then
        # label-preserving); tie-improvements join the next frontier so
        # the winning labels propagate, and terminate because (o, l)
        # strictly decreases per key
        improved = (nw < old_w - 1e-12) | (
            (nw < old_w + 1e-12)
            & ((no < old_o) | ((no == old_o) & ~nl & old_l)))
        if not improved.any():
            break
        ns, nu, nw = ns[improved], nu[improved], nw[improved]
        no, nl = no[improved], nl[improved]
        ns, nu, nw, no, nl = dedup_pairs(ns, nu, nw, no, nl)
        cs = np.concatenate([cs, ns]); cu = np.concatenate([cu, nu])
        cw = np.concatenate([cw, nw]); co = np.concatenate([co, no])
        cl = np.concatenate([cl, nl])
        cs, cu, cw, co, cl = dedup_pairs(cs, cu, cw, co, cl)
        if len(cs) > max_pairs:
            raise ValueError(
                f"epsilon closure exceeded {max_pairs} pairs — the eps "
                "subgraph is too dense; remove epsilons offline")
        frontier = (ns, nu, nw, no, nl)
    else:
        raise ValueError("epsilon closure did not converge "
                         f"in {max_iters} rounds")

    # eps-cycle pairs (s ->eps+-> s) are dominated by the identity
    # (dist 0, no labels) under non-negative weights — drop them, exactly
    # as the scalar path's dist[s] = 0 initialization does
    keep = cs != cu
    cs, cu, cw, co, cl = cs[keep], cu[keep], cw[keep], co[keep], cl[keep]

    dropped = 0
    # finals: final'(s) = min(final(s), min_u dist(s,u) + final(u))
    final = np.array(g.final_cost, dtype=np.float64)
    if len(cs):
        fc = cw + g.final_cost[cu]
        order = np.lexsort((fc, cs))
        s_sorted = cs[order]
        first = np.ones(len(s_sorted), bool)
        if len(s_sorted) > 1:
            first[1:] = s_sorted[1:] != s_sorted[:-1]
        wins = order[first]
        better = fc[wins] < final[cs[wins]] - 1e-12
        dropped += int(np.count_nonzero(
            better & (co[wins] != 0) | (better & cl[wins])))
        np.minimum.at(final, cs, fc)

    # emitting arcs: closure pairs (incl. identity) joined with the
    # original emitting arcs on closure.dst == arc.src
    ide = np.arange(S, dtype=np.int64)
    js = np.concatenate([cs, ide])
    ju = np.concatenate([cu, ide])
    jw = np.concatenate([cw, np.zeros(S)])
    jo = np.concatenate([co, np.zeros(S, np.int64)])
    jl = np.concatenate([cl, np.zeros(S, bool)])

    m_src = np.repeat(np.arange(S, dtype=np.int64),
                      np.diff(g.em_row_ptr).astype(np.int64))
    mord = np.argsort(m_src, kind="stable")
    m_src_sorted = m_src[mord]
    m_dst = g.em_dst.astype(np.int64)[mord]
    m_il = g.em_ilabel.astype(np.int64)[mord]
    m_ol = g.em_olabel.astype(np.int64)[mord]
    m_w = g.em_weight.astype(np.float64)[mord]

    lo = np.searchsorted(m_src_sorted, ju, "left")
    hi = np.searchsorted(m_src_sorted, ju, "right")
    cnt = hi - lo
    total = int(cnt.sum())
    rep = np.repeat(np.arange(len(js)), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    mi = np.repeat(lo, cnt) + within

    rs = js[rep]
    rd = m_dst[mi]
    ril = m_il[mi]
    own = m_ol[mi]
    route_o = jo[rep]
    rol = np.where(own != 0, own, route_o)
    rw = jw[rep] + m_w[mi]
    rloses = jl[rep] | ((own != 0) & (route_o != 0))

    # best arc per (s, d, il, ol)
    order = np.lexsort((rw, rol, ril, rd, rs))
    rs, rd, ril, rol, rw, rloses = (x[order] for x in
                                    (rs, rd, ril, rol, rw, rloses))
    first = np.ones(len(rs), bool)
    if len(rs) > 1:
        first[1:] = ((rs[1:] != rs[:-1]) | (rd[1:] != rd[:-1])
                     | (ril[1:] != ril[:-1]) | (rol[1:] != rol[:-1]))
    rs, rd, ril, rol, rw, rloses = (x[first] for x in
                                    (rs, rd, ril, rol, rw, rloses))
    dropped += int(np.count_nonzero(rloses))

    if dropped:
        import sys
        print(f"warning: remove_epsilons lost word labels on {dropped} "
              "surviving arcs/finals (multi-label eps routes or labeled "
              "eps into labeled/final arcs; costs stay exact — push "
              "labels in the graph build to avoid this)",
              file=sys.stderr)

    row_ptr = np.zeros(S + 1, np.int64)
    np.add.at(row_ptr, rs + 1, 1)
    return DecodingGraph(
        num_states=S, start=g.start,
        em_row_ptr=np.cumsum(row_ptr),
        em_dst=rd.astype(np.int32),
        em_ilabel=ril.astype(np.int32),
        em_olabel=rol.astype(np.int32),
        em_weight=rw,
        eps_row_ptr=np.zeros(S + 1, np.int64),
        eps_dst=np.empty(0, np.int32),
        eps_olabel=np.empty(0, np.int32),
        eps_weight=np.empty(0, np.float64),
        final_cost=final,
        ilabel_to_pdf=g.ilabel_to_pdf,
    )
