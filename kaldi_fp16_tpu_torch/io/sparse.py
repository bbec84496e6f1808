"""CSR / COO forms of an FST for the chain objective: the port's own copy
of what it uses of kaldi_fp16_tpu/io/sparse.py.  Arcs are flat numpy
arrays; tropical weights are negated into log-probs on the arcs AND the
final weights.  `fst_to_csr` reads any object with the `Fst` fields
(`start`, `states`, `num_states`, optional `flat` arc arrays), so FSTs
built by either package convert alike.  `csr_to_coo` and `merge_coo`
(sparse.py:134-167 there) turn a CSR back into arcs and concatenate
per-example FSTs with state offsets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.io.fst import Fst


@dataclass
class CSR:
    """CSR form: arcs sorted by source state.  Weights are log-probs."""
    num_states: int
    row_ptr: np.ndarray       # int32 [num_states + 1]
    col_idx: np.ndarray       # int32 [num_arcs] destination state
    labels: np.ndarray        # int32 [num_arcs] pdf-id, 1-indexed (0 = epsilon)
    weights: np.ndarray       # float32 [num_arcs] log-prob (= -tropical weight)
    final_states: np.ndarray  # int32 [num_final]
    final_weights: np.ndarray # float32 [num_final] log-prob
    start_state: int = 0

    @property
    def num_arcs(self) -> int:
        return len(self.col_idx)

    def label_dim(self) -> int:
        """Max label (= number of pdfs, labels being 1-indexed)."""
        return int(self.labels.max()) if len(self.labels) else 0

    def src_states(self) -> np.ndarray:
        """Expand row_ptr into per-arc source-state indices."""
        return np.repeat(np.arange(self.num_states, dtype=np.int32),
                         np.diff(self.row_ptr).astype(np.int64))

    def validate(self) -> None:
        rp = self.row_ptr
        if len(rp) != self.num_states + 1 or rp[0] != 0 or rp[-1] != self.num_arcs:
            raise ValueError("CSR: bad row_ptr bounds")
        if np.any(np.diff(rp) < 0):
            raise ValueError("CSR: row_ptr not monotonic")
        if self.num_arcs and (self.col_idx.min() < 0 or
                              self.col_idx.max() >= self.num_states):
            raise ValueError("CSR: col_idx out of range")
        if len(self.final_states) and (self.final_states.min() < 0 or
                                       self.final_states.max() >= self.num_states):
            raise ValueError("CSR: final state out of range")


@dataclass
class COO:
    """COO form.  Weights are log-probs."""
    num_states: int
    rows: np.ndarray          # int32 [num_arcs] source state
    cols: np.ndarray          # int32 [num_arcs] destination state
    labels: np.ndarray        # int32 [num_arcs]
    weights: np.ndarray       # float32 [num_arcs]
    final_states: np.ndarray
    final_weights: np.ndarray
    start_state: int = 0

    @property
    def num_arcs(self) -> int:
        return len(self.rows)


def _extract_arcs(fst: Fst):
    flat = getattr(fst, "flat", None)
    if flat is not None:
        # native-parser fast path: the flat arc arrays ARE the FST; no
        # FstState/FstArc object walk (negation here matches the object
        # path below — tropical -> log-prob on arcs AND finals)
        src, dst, lab, wgt, fs, fw = flat
        return (src, dst, lab, (-wgt).astype(np.float32),
                fs, (-fw).astype(np.float32))
    rows, cols, labels, weights = [], [], [], []
    final_states, final_weights = [], []
    for s, st in enumerate(fst.states):
        for a in st.arcs:
            rows.append(s)
            cols.append(a.next_state)
            labels.append(a.label)
            weights.append(-a.weight)      # tropical -> log-prob
        if st.is_final:
            final_states.append(s)
            final_weights.append(-st.final)  # tropical -> log-prob
    return (np.asarray(rows, dtype=np.int32),
            np.asarray(cols, dtype=np.int32),
            np.asarray(labels, dtype=np.int32),
            np.asarray(weights, dtype=np.float32),
            np.asarray(final_states, dtype=np.int32),
            np.asarray(final_weights, dtype=np.float32))


def fst_to_coo(fst: Fst) -> COO:
    if fst is None or fst.num_states <= 0:
        raise ValueError("empty FST")
    rows, cols, labels, weights, fs, fw = _extract_arcs(fst)
    return COO(num_states=fst.num_states, rows=rows, cols=cols, labels=labels,
               weights=weights, final_states=fs, final_weights=fw,
               start_state=fst.start)


def fst_to_csr(fst: Fst) -> CSR:
    return coo_to_csr(fst_to_coo(fst))


def coo_to_csr(coo: COO) -> CSR:
    """Stable sort by source row (ref: sparse.go:173-212)."""
    order = np.argsort(coo.rows, kind="stable")
    rows = coo.rows[order]
    counts = np.bincount(rows, minlength=coo.num_states).astype(np.int64)
    row_ptr = np.zeros(coo.num_states + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(num_states=coo.num_states,
               row_ptr=row_ptr,
               col_idx=coo.cols[order],
               labels=coo.labels[order],
               weights=coo.weights[order],
               final_states=coo.final_states,
               final_weights=coo.final_weights,
               start_state=coo.start_state)


def csr_to_coo(csr: CSR) -> COO:
    return COO(num_states=csr.num_states,
               rows=csr.src_states(),
               cols=csr.col_idx.copy(),
               labels=csr.labels.copy(),
               weights=csr.weights.copy(),
               final_states=csr.final_states,
               final_weights=csr.final_weights,
               start_state=csr.start_state)


def merge_coo(fsts: List[COO]) -> Tuple[COO, np.ndarray]:
    """Concatenate per-example FSTs with state offsets (ref:
    sparse.go:217-261).  Returns (merged, offsets), offsets[i] the state
    offset of FST i."""
    if not fsts:
        raise ValueError("empty FST list")
    sizes = np.array([f.num_states for f in fsts], dtype=np.int32)
    offsets = np.zeros(len(fsts), dtype=np.int32)
    np.cumsum(sizes[:-1], out=offsets[1:])
    merged = COO(
        num_states=int(sizes.sum()),
        rows=np.concatenate([f.rows + o for f, o in zip(fsts, offsets)]),
        cols=np.concatenate([f.cols + o for f, o in zip(fsts, offsets)]),
        labels=np.concatenate([f.labels for f in fsts]),
        weights=np.concatenate([f.weights for f in fsts]),
        final_states=np.concatenate([f.final_states + o
                                     for f, o in zip(fsts, offsets)]),
        final_weights=np.concatenate([f.final_weights for f in fsts]),
        start_state=0,
    )
    return merged, offsets
