"""OpenFst binary format: reader and writer.

Formats handled (ref: internal/parser/fst.go:10-172):

  * header: magic 0x7eb2fdd6 (int32), fst_type string, arc_type string
    ("standard"), version i32, flags i32, properties u64, start i64,
    numstates i64, numarcs i64.  Strings are int32 length + bytes.
  * "compact_acceptor": (numstates+1) uint32 state offsets into a compacts
    array of 12-byte elements (label i32, weight f32, nextstate i32);
    nextstate == -1 marks the final weight for the state.  Used for the
    per-utterance chain supervision FSTs inside cegs.
  * "vector": per state: final weight f32, narcs i64, then per arc
    ilabel i32, olabel i32, weight f32, nextstate i32.  Used for den.fst.

Weights are tropical semiring = -log(prob).  Final weight +inf = not final.

Copy of kaldi_fp16_tpu/io/fst.py (the port imports nothing of the
JAX package); tests/test_torch_egs_io.py holds the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter

FST_MAGIC = 0x7EB2FDD6
NO_STATE_ID = -1
INF = float("inf")


@dataclass
class FstArc:
    label: int          # ilabel (== olabel for acceptors); pdf-id + 1 for chain FSTs
    weight: float       # tropical: -log(prob)
    next_state: int
    olabel: int = -1    # output label for transducers (HCLG); -1 => acceptor

    def __post_init__(self):
        if self.olabel < 0:
            self.olabel = self.label


@dataclass
class FstState:
    final: float = INF  # final weight; +inf means not final
    arcs: List[FstArc] = field(default_factory=list)

    @property
    def is_final(self) -> bool:
        return not math.isinf(self.final)


@dataclass
class Fst:
    start: int
    states: List[FstState]
    properties: int = 0

    @property
    def num_states(self) -> int:
        return len(self.states)

    @property
    def num_arcs(self) -> int:
        return sum(len(s.arcs) for s in self.states)


def _read_string(r: BinaryReader) -> str:
    n = r.read_uint32()
    return r.read_bytes(n).decode("ascii")


def _write_string(w: BinaryWriter, s: str) -> None:
    b = s.encode("ascii")
    w.write_uint32(len(b))
    w.write_bytes(b)


def read_fst(r: BinaryReader) -> Optional[Fst]:
    """Read an OpenFst binary FST; returns None on unsupported format."""
    magic = r.read_uint32()
    if magic != FST_MAGIC:
        return None
    fst_type = _read_string(r)
    arc_type = _read_string(r)
    if arc_type != "standard":
        return None

    _version = r.read_int32()
    _flags = r.read_int32()
    properties = r.read_uint64()
    start = r.read_int64()
    num_states = r.read_int64()
    _num_arcs = r.read_int64()

    if fst_type == "compact_acceptor":
        return _read_compact_acceptor(r, start, num_states, properties)
    if fst_type == "vector":
        return _read_vector(r, start, num_states, properties)
    return None


def _read_compact_acceptor(r: BinaryReader, start: int, num_states: int,
                           properties: int) -> Fst:
    offsets = [r.read_uint32() for _ in range(num_states + 1)]
    ncompacts = offsets[num_states]
    compacts = []
    for _ in range(ncompacts):
        label = r.read_int32()
        weight = r.read_float32()
        next_state = r.read_int32()
        compacts.append((label, weight, next_state))

    states = []
    for s in range(num_states):
        st = FstState()
        for i in range(offsets[s], offsets[s + 1]):
            label, weight, next_state = compacts[i]
            if next_state == NO_STATE_ID:
                st.final = weight
            else:
                st.arcs.append(FstArc(label, weight, next_state))
        states.append(st)
    return Fst(start=start, states=states, properties=properties)


def _read_vector(r: BinaryReader, start: int, num_states: int,
                 properties: int) -> Fst:
    states = []
    for _ in range(num_states):
        final = r.read_float32()
        narcs = r.read_int64()
        st = FstState(final=final)
        for _ in range(narcs):
            ilabel = r.read_int32()
            olabel = r.read_int32()
            weight = r.read_float32()
            next_state = r.read_int32()
            st.arcs.append(FstArc(ilabel, weight, next_state, olabel=olabel))
        states.append(st)
    return Fst(start=start, states=states, properties=properties)


def _write_header(w: BinaryWriter, fst_type: str, fst: Fst, num_arcs: int) -> None:
    w.write_uint32(FST_MAGIC)
    _write_string(w, fst_type)
    _write_string(w, "standard")
    w.write_int32(2)            # version
    w.write_int32(0)            # flags
    w.write_uint64(fst.properties)
    w.write_int64(fst.start)
    w.write_int64(fst.num_states)
    w.write_int64(num_arcs)


def write_fst_compact_acceptor(w: BinaryWriter, fst: Fst) -> None:
    """Emit compact_acceptor binary (the supervision-FST container format)."""
    compacts = []
    offsets = [0]
    for st in fst.states:
        # OpenFst CompactFst stores the final-weight element first
        if st.is_final:
            compacts.append((0, st.final, NO_STATE_ID))
        for a in st.arcs:
            compacts.append((a.label, a.weight, a.next_state))
        offsets.append(len(compacts))

    _write_header(w, "compact_acceptor", fst, len(compacts))
    for off in offsets:
        w.write_uint32(off)
    for label, weight, next_state in compacts:
        w.write_int32(label)
        w.write_float32(weight)
        w.write_int32(next_state)


def write_fst_vector(w: BinaryWriter, fst: Fst) -> None:
    """Emit vector binary (the den.fst container format)."""
    _write_header(w, "vector", fst, 0)  # header numArcs is 0 for vector FSTs
    for st in fst.states:
        w.write_float32(st.final)
        w.write_int64(len(st.arcs))
        for a in st.arcs:
            w.write_int32(a.label)
            w.write_int32(a.olabel)
            w.write_float32(a.weight)
            w.write_int32(a.next_state)


def read_fst_file(path: str) -> Optional[Fst]:
    with BinaryReader.open(path) as r:
        return read_fst(r)


def write_fst_file(path: str, fst: Fst, fmt: str = "vector") -> None:
    w = BinaryWriter()
    if fmt == "vector":
        write_fst_vector(w, fst)
    elif fmt == "compact_acceptor":
        write_fst_compact_acceptor(w, fst)
    else:
        raise ValueError(f"unknown fst format {fmt}")
    with open(path, "wb") as f:
        f.write(w.getvalue())
