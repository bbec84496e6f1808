"""Host-side chain decomposition of a denominator graph (numpy only).

Copy of `ChainLayout`, `pad_chains` and `analyze_chain_structure` from
kaldi_fp16_tpu/chain/den_structured.py.  That module imports only numpy at
load time, but the JAX package's `chain/__init__` imports jax, so the port
carries its own copy; tests/test_torch_denominator.py holds the arrays
equal to the JAX package's.

A real den.fst is a phone-LM over left-to-right HMM chains.  The
decomposition puts self-loops on an elementwise [L, F] slot layout
(L = padded chain length, F = number of chains), in-chain arcs on a shift
along L, and every other ("residual") arc, which always runs from a chain
end to a chain start, into one dense [F, F] matrix M.  See
chain/den_structured.py for the recursions that use it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ChainLayout:
    """Host-side decomposition of a DenominatorGraph into chain form."""
    F: int                      # number of chains
    L: int                      # padded chain length (max over chains)
    num_states: int             # original S
    num_pdfs: int
    # state <-> slot mapping; slot = (pos k, chain f)
    pos_of_state: np.ndarray    # int32 [S]
    chain_of_state: np.ndarray  # int32 [S]
    state_of_slot: np.ndarray   # int32 [L, F], -1 for padding
    # per-slot self-loop arrays [L, F]
    self_pdf: np.ndarray        # int32 (0 where absent)
    self_coef: np.ndarray       # float32 prob * mask
    # chain (k -> k+1) arrays [max(L-1,0), F]
    fwd_pdf: np.ndarray
    fwd_coef: np.ndarray
    # residual dense part
    M: np.ndarray               # float32 [F, F]: sum prob over (end u -> start v)
    res_pdf: np.ndarray         # int32 [F] pdf of residual arcs into start of chain f
    res_mask: np.ndarray        # float32 [F]
    # chains sorted by length; groups of equal length as (len, f_lo, f_hi)
    groups: List[Tuple[int, int, int]]
    init: np.ndarray            # float32 [L, F] warmup initial probs (0 on padding)
    real: np.ndarray            # bool [L, F]

    @property
    def num_slots(self) -> int:
        return self.L * self.F


def pad_chains(lay: "ChainLayout", multiple: int = 128) -> "ChainLayout":
    """Pad the chain axis F to a multiple with inert fake chains (zero
    coefs/init/mask, real=False, zero M rows+cols).  All kernels remain
    semantically identical (the fake slots carry exact zeros end to end);
    required by the fused Pallas scans, harmless (~2-3% waste) for the
    XLA path.  Only valid for single-group layouts (every chain the same
    length), which is what the fused path supports."""
    assert len(lay.groups) == 1
    F, L = lay.F, lay.L
    Fp = -(-F // multiple) * multiple
    if Fp == F:
        return lay
    pad = Fp - F

    def padF(a, axis):
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, pad)
        return np.pad(a, widths)

    return ChainLayout(
        F=Fp, L=L, num_states=lay.num_states, num_pdfs=lay.num_pdfs,
        pos_of_state=lay.pos_of_state, chain_of_state=lay.chain_of_state,
        state_of_slot=np.pad(lay.state_of_slot, ((0, 0), (0, pad)),
                             constant_values=-1),
        self_pdf=padF(lay.self_pdf, 1),
        self_coef=padF(lay.self_coef, 1),
        fwd_pdf=padF(lay.fwd_pdf, 1),
        fwd_coef=padF(lay.fwd_coef, 1),
        M=np.pad(lay.M, ((0, pad), (0, pad))),
        res_pdf=padF(lay.res_pdf, 0),
        res_mask=padF(lay.res_mask, 0),
        groups=[(L, 0, Fp)],
        init=padF(lay.init, 1),
        real=padF(lay.real, 1),
    )


def analyze_chain_structure(graph, max_len: int = 8,
                            max_dense_states: int = 4096
                            ) -> Optional[ChainLayout]:
    """Decompose `graph` (DenominatorGraph SoA arrays) into ChainLayout,
    or None when the structured kernels don't apply."""
    S = graph.num_states
    src = np.asarray(graph.src, np.int64)
    dst = np.asarray(graph.dst, np.int64)
    pdf = np.asarray(graph.pdf, np.int64)
    prob = np.asarray(graph.prob, np.float64)
    if S == 0 or len(src) == 0:
        return None

    is_self = src == dst
    ns = ~is_self
    ns_src, ns_dst = src[ns], dst[ns]
    ns_idx = np.nonzero(ns)[0]
    out_deg = np.bincount(ns_src, minlength=S)
    in_deg = np.bincount(ns_dst, minlength=S)

    # candidate chain arcs: unique non-self out-arc of src AND unique
    # non-self in-arc of dst
    cand = (out_deg[ns_src] == 1) & (in_deg[ns_dst] == 1)
    nxt = np.full(S, -1, np.int64)          # chain successor per state
    chain_arc_of = np.full(S, -1, np.int64)  # arc index of the chain arc from s
    nxt[ns_src[cand]] = ns_dst[cand]
    chain_arc_of[ns_src[cand]] = ns_idx[cand]

    # heads: states with no incoming chain arc
    has_chain_in = np.zeros(S, bool)
    has_chain_in[ns_dst[cand]] = True
    heads = np.nonzero(~has_chain_in)[0]

    chain_of_state = np.full(S, -1, np.int64)
    pos_of_state = np.full(S, -1, np.int64)
    chains: List[List[int]] = []
    demoted_arcs: List[int] = []

    for h in heads:
        cur: List[int] = []
        s = h
        while s >= 0 and chain_of_state[s] < 0:
            if len(cur) == max_len:
                # split: the arc into s becomes residual; s starts a new chain
                prev = cur[-1]
                demoted_arcs.append(int(chain_arc_of[prev]))
                chain_arc_of[prev] = -1
                chains.append(cur)
                cur = []
            chain_of_state[s] = -2  # visiting
            cur.append(int(s))
            s = int(nxt[s])
        if cur:
            chains.append(cur)

    # pure cycles of chain arcs (never reached from a head): break them into
    # singleton chains, demoting every chain arc inside
    for s0 in range(S):
        if chain_of_state[s0] != -1:
            continue
        s = s0
        while chain_of_state[s] == -1:
            chain_of_state[s] = -2
            if chain_arc_of[s] >= 0:
                demoted_arcs.append(int(chain_arc_of[s]))
                chain_arc_of[s] = -1
            chains.append([s])
            s = int(nxt[s])

    # order chains by length (stable) so equal lengths are contiguous slices
    chains.sort(key=len)
    F = len(chains)
    if F > max_dense_states:
        return None
    L = max(len(c) for c in chains)
    groups: List[Tuple[int, int, int]] = []
    for f, c in enumerate(chains):
        for k, s in enumerate(c):
            chain_of_state[s] = f
            pos_of_state[s] = k
        if groups and groups[-1][0] == len(c):
            groups[-1] = (groups[-1][0], groups[-1][1], f + 1)
        else:
            groups.append((len(c), f, f + 1))

    # classify arcs
    chain_arc_set = set(int(a) for a in chain_arc_of if a >= 0)
    demoted = set(demoted_arcs)

    self_pdf = np.zeros((L, F), np.int64)
    self_coef = np.zeros((L, F), np.float64)
    fwd_pdf = np.zeros((max(L - 1, 1), F), np.int64)
    fwd_coef = np.zeros((max(L - 1, 1), F), np.float64)
    M = np.zeros((F, F), np.float64)
    res_pdf = np.full(F, -1, np.int64)
    res_mask = np.zeros(F, np.float64)

    # pass 1: non-self arcs (chain arcs + residual); residual fixes res_pdf
    self_arc_lists: dict = {}
    for a in range(len(src)):
        u, v, p, w = int(src[a]), int(dst[a]), int(pdf[a]), float(prob[a])
        if is_self[a]:
            self_arc_lists.setdefault(u, []).append((p, w))
            continue
        ku, fu = int(pos_of_state[u]), int(chain_of_state[u])
        kv, fv = int(pos_of_state[v]), int(chain_of_state[v])
        if a in chain_arc_set and a not in demoted:
            assert fv == fu and kv == ku + 1
            fwd_pdf[ku, fu] = p
            fwd_coef[ku, fu] = w
        else:
            # residual: src must be its chain's end, dst a chain start
            if ku != len(chains[fu]) - 1 or kv != 0:
                return None          # can't happen by construction; be safe
            if res_pdf[fv] >= 0 and res_pdf[fv] != p:
                return None          # pdf not determined by destination
            res_pdf[fv] = p
            res_mask[fv] = 1.0
            M[fu, fv] += w

    # pass 2: self-loops.  One per state fits the elementwise self slot;
    # extra self-loops of a SINGLETON chain (state is both chain end and
    # chain start — e.g. the phone-LM self-transition of a 1-state phone)
    # can ride the dense residual diagonal M[f, f] when their pdf agrees
    # with the other residual arcs into that start.
    for u, arcs in self_arc_lists.items():
        ku, fu = int(pos_of_state[u]), int(chain_of_state[u])
        singleton = len(chains[fu]) == 1
        leftover = []
        if len(arcs) > 1 and singleton:
            for p, w in arcs:
                if res_pdf[fu] < 0 or res_pdf[fu] == p:
                    res_pdf[fu] = p
                    res_mask[fu] = 1.0
                    M[fu, fu] += w
                else:
                    leftover.append((p, w))
        else:
            leftover = arcs
        if len(leftover) > 1:
            return None              # can't express >1 distinct self slots
        if leftover:
            self_pdf[ku, fu] = leftover[0][0]
            self_coef[ku, fu] = leftover[0][1]

    state_of_slot = np.full((L, F), -1, np.int64)
    init = np.zeros((L, F), np.float64)
    for f, c in enumerate(chains):
        for k, s in enumerate(c):
            state_of_slot[k, f] = s
            init[k, f] = graph.initial[s]
    real = state_of_slot >= 0

    return ChainLayout(
        F=F, L=L, num_states=S, num_pdfs=graph.num_pdfs,
        pos_of_state=pos_of_state.astype(np.int32),
        chain_of_state=chain_of_state.astype(np.int32),
        state_of_slot=state_of_slot.astype(np.int32),
        self_pdf=np.maximum(self_pdf, 0).astype(np.int32),
        self_coef=self_coef.astype(np.float32),
        fwd_pdf=np.maximum(fwd_pdf, 0).astype(np.int32),
        fwd_coef=fwd_coef.astype(np.float32),
        M=M.astype(np.float32),
        res_pdf=np.maximum(res_pdf, 0).astype(np.int32),
        res_mask=res_mask.astype(np.float32),
        groups=groups,
        init=init.astype(np.float32),
        real=real,
    )
