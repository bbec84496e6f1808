"""Chain graphs in device-friendly static-shape form.

DenominatorGraph (ref: internal/nnet/denominator.go:68-171, Kaldi
chain-den-graph.cc): transitions as SoA arrays with 0-indexed pdfs and
probability-space weights exp(-tropical), plus initial state probabilities
from a 100-iteration float64 HMM power-method warmup.

NumeratorGraphBatch: per-utterance supervision FSTs padded to a common
(max_states, max_arcs) so a whole minibatch is one set of rectangular
arrays — the TPU-native replacement for the reference's per-sequence
CSR uploads (ref: chain_loss.go:44-127).  Padding arcs carry mask=0 and
are routed to a dummy state/pdf so they contribute nothing.

Copy of kaldi_fp16_tpu/chain/graph.py (numpy only).  The JAX package's
`chain/__init__` imports jax, so the port carries its own copy, and its
own copies of the FST classes and the CSR conversion (kaldi_fp16_tpu_torch/
io).  tests/test_torch_denominator.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu_torch.io.sparse import CSR, fst_to_csr

LOG_ZERO = -1.0e30  # matches reference kLogZero (chain.cu:37)


# ---------------------------------------------------------------------------
# Denominator graph
# ---------------------------------------------------------------------------

@dataclass
class DenominatorGraph:
    """Shared denominator HMM in probability space.

    Arcs with label 0 (epsilon) are dropped, pdf = label - 1
    (ref: denominator.go:83-100).  transitions sorted by dst so the
    device-side segment-sum scatter can assume sorted segment ids.
    """
    src: np.ndarray          # int32 [A]
    dst: np.ndarray          # int32 [A]  (sorted ascending)
    pdf: np.ndarray          # int32 [A]  0-indexed
    prob: np.ndarray         # float32 [A] exp(-tropical_weight)
    initial: np.ndarray      # float32 [S] from 100-iter fp64 warmup
    num_states: int
    num_pdfs: int
    start_state: int

    @property
    def num_transitions(self) -> int:
        return len(self.src)

    @classmethod
    def from_fst(cls, fst: Fst, num_pdfs: int) -> "DenominatorGraph":
        src, dst, pdf, prob = [], [], [], []
        for s, st in enumerate(fst.states):
            for a in st.arcs:
                p = a.label - 1
                if p < 0:
                    continue
                src.append(s)
                dst.append(a.next_state)
                pdf.append(p)
                prob.append(np.exp(np.float64(-a.weight)))
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        pdf = np.asarray(pdf, dtype=np.int32)
        prob = np.asarray(prob, dtype=np.float32)

        order = np.argsort(dst, kind="stable")
        g = cls(src=src[order], dst=dst[order], pdf=pdf[order], prob=prob[order],
                initial=np.zeros(fst.num_states, dtype=np.float32),
                num_states=fst.num_states, num_pdfs=num_pdfs,
                start_state=fst.start)
        g.initial = g._compute_initial_probs()
        return g

    def _compute_initial_probs(self) -> np.ndarray:
        """Kaldi DenominatorGraph::SetInitialProbs: average of 100 normalized
        HMM propagation steps, float64 (ref: denominator.go:131-171)."""
        S = self.num_states
        cur = np.zeros(S, dtype=np.float64)
        cur[self.start_state] = 1.0
        avg = np.zeros(S, dtype=np.float64)
        prob64 = self.prob.astype(np.float64)
        for _ in range(100):
            avg += cur / 100.0
            nxt = np.zeros(S, dtype=np.float64)
            np.add.at(nxt, self.dst, cur[self.src] * prob64)
            total = nxt.sum()
            if total > 0:
                nxt /= total
            cur = nxt
        return avg.astype(np.float32)


def make_simple_den_fst(num_pdfs: int, num_states: int = 4,
                        seed: int = 0, arcs_per_state: int = 3) -> Fst:
    """Small random ergodic denominator FST for tests and smoke training.

    Every state is final with weight 0 (prob 1), matching the chain
    denominator convention "all states final" (ref: chain_den.cu:7)."""
    rng = np.random.default_rng(seed)
    states = [FstState(final=0.0) for _ in range(num_states)]
    for s in range(num_states):
        for _ in range(arcs_per_state):
            label = int(rng.integers(1, num_pdfs + 1))
            w = float(rng.uniform(0.5, 2.0))  # tropical -log prob
            nxt = int(rng.integers(0, num_states))
            states[s].arcs.append(FstArc(label, w, nxt))
    return Fst(start=0, states=states)


def make_phone_lm_den_fst(num_pdfs: int = 3080, num_phones: int = 3526,
                          states_per_phone: int = 2, branching: int = 28,
                          seed: int = 0) -> Fst:
    """Denominator FST with the REAL topology class: a phone-LM over
    left-to-right HMMs (what `chain-est-phone-lm | chain-make-den-fst`
    produces), instead of a uniformly random graph.

    Each phone is a chain of `states_per_phone` states with self-loops;
    the last state fans out to `branching` random phone-initial states
    (the n-gram phone-LM transitions).  pdf-ids are assigned per
    (phone, state) round-robin over num_pdfs.  Defaults reproduce the
    production scale: 7052 states, ~113K arcs, 3080 pdfs
    (ref: den.fst structure, docs report — 7052 states / 113,380 arcs).
    Every state is final with weight 0 (chain convention).  Unlike the
    random generator this graph has gather locality (self-loops and
    in-phone arcs touch neighboring states), which is what the blocked
    denominator kernels see in production."""
    rng = np.random.default_rng(seed)
    S = num_phones * states_per_phone
    states = [FstState(final=0.0) for _ in range(S)]
    pdf_of_state = (np.arange(S, dtype=np.int64) % num_pdfs) + 1
    initials = np.arange(num_phones, dtype=np.int64) * states_per_phone
    for ph in range(num_phones):
        base = ph * states_per_phone
        for k in range(states_per_phone):
            s = base + k
            lbl = int(pdf_of_state[s])
            # self-loop (HMM state persistence)
            states[s].arcs.append(
                FstArc(lbl, float(rng.uniform(0.3, 1.2)), s))
            if k + 1 < states_per_phone:
                nxt = s + 1
                states[s].arcs.append(
                    FstArc(int(pdf_of_state[nxt]),
                           float(rng.uniform(0.3, 1.2)), nxt))
        # phone-LM fan-out from the last state to successor phone starts
        last = base + states_per_phone - 1
        succ = rng.choice(num_phones, size=min(branching, num_phones),
                          replace=False)
        for sp in succ:
            dst = int(initials[sp])
            states[last].arcs.append(
                FstArc(int(pdf_of_state[dst]),
                       float(rng.uniform(1.0, 4.0)), dst))
    return Fst(start=0, states=states)


# ---------------------------------------------------------------------------
# Numerator graph batch (padded static shapes)
# ---------------------------------------------------------------------------

@dataclass
class NumeratorGraphBatch:
    """B supervision FSTs padded to (max_states S, max_arcs A).

    All log-domain.  Padding arcs have mask 0, src=dst=S-1... no: padding
    arcs use src=dst=0 with value masked to LOG_ZERO before the scatter, so
    they never contribute.  final_logw is -inf (LOG_ZERO) for non-final
    states.  pdf is 0-indexed; padding pdf = 0 (read of nnet[0] is masked).
    """
    arc_src: np.ndarray      # int32 [B, A]
    arc_dst: np.ndarray      # int32 [B, A]
    arc_pdf: np.ndarray      # int32 [B, A] 0-indexed
    arc_logw: np.ndarray     # float32 [B, A] log-prob
    arc_mask: np.ndarray     # float32 [B, A] 1 = real arc
    start: np.ndarray        # int32 [B]
    final_logw: np.ndarray   # float32 [B, S]; LOG_ZERO if not final
    num_states: int          # S (padded)
    num_arcs: int            # A (padded)

    @property
    def batch_size(self) -> int:
        return self.arc_src.shape[0]


def build_numerator_batch(csrs: Sequence[CSR],
                          max_states: int = 0,
                          max_arcs: int = 0) -> NumeratorGraphBatch:
    """Pad per-utterance CSR FSTs into one rectangular batch.

    Labels are 1-indexed in the CSR (0 = epsilon); epsilon arcs are masked
    out like the reference kernels do (ref: chain.cu:113-118).
    """
    B = len(csrs)
    S = max(max_states, max(c.num_states for c in csrs))
    A = max(max_arcs, max(c.num_arcs for c in csrs), 1)

    arc_src = np.zeros((B, A), dtype=np.int32)
    arc_dst = np.zeros((B, A), dtype=np.int32)
    arc_pdf = np.zeros((B, A), dtype=np.int32)
    arc_logw = np.zeros((B, A), dtype=np.float32)
    arc_mask = np.zeros((B, A), dtype=np.float32)
    start = np.zeros(B, dtype=np.int32)
    final_logw = np.full((B, S), LOG_ZERO, dtype=np.float32)

    for b, c in enumerate(csrs):
        n = c.num_arcs
        src = c.src_states()
        valid = c.labels > 0  # epsilon arcs masked
        arc_src[b, :n] = src
        arc_dst[b, :n] = c.col_idx
        arc_pdf[b, :n] = np.maximum(c.labels - 1, 0)
        arc_logw[b, :n] = c.weights
        arc_mask[b, :n] = valid.astype(np.float32)
        start[b] = c.start_state
        final_logw[b, c.final_states] = c.final_weights

    return NumeratorGraphBatch(arc_src=arc_src, arc_dst=arc_dst, arc_pdf=arc_pdf,
                               arc_logw=arc_logw, arc_mask=arc_mask, start=start,
                               final_logw=final_logw, num_states=S, num_arcs=A)


def build_numerator_batch_from_fsts(fsts: Sequence[Fst], **kw) -> NumeratorGraphBatch:
    return build_numerator_batch([fst_to_csr(f) for f in fsts], **kw)
