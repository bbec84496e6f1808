"""Kaldi NnetChainExample (cegs) binary ark reader and writer.

Structure (ref: internal/parser/parser.go:163-302,
docs/kaldi-egs-format.md; Kaldi nnet3/nnet-chain-example.cc semantics):

  key \\0B <Nnet3ChainEg> <NumInputs> N
    <NnetIo> input  <I1V> n [delta-coded indexes] CM  <payload> </NnetIo>
    <NnetIo> ivector <I1V> 1 [indexes]            CM2 <payload> </NnetIo>
  <NumOutputs> 1
    <NnetChainSup> output <I1V> n [indexes]
      <Supervision> <Weight> w <NumSequences> n <FramesPerSeq> f
        <LabelDim> d <End2End> F [OpenFst binary compact_acceptor]
      </Supervision>
      <DW2> FV [floats]            (or <DW> FV [bytes/255])
    </NnetChainSup>
  </Nnet3ChainEg>

Index vectors are delta-coded (ref: parser.go:484-548; Kaldi nnet-common.cc
WriteIndexVectorElementBinary): one signed byte per element holding the
t-delta when n and x match the previous index and |delta| < 125; byte 127
introduces the long form (n, t, x each as WriteBasicType: size byte 4 +
int32).  Note the reference Go reader mis-frames the long form (it consumes
the \\x04 size byte as a phantom space); we parse it correctly, and our
read_basic_int treats a leading 0x20 as an optional skip so both the
token-space and raw-binary contexts work.

The writer emits the same byte format so that tests can round-trip and so
synthetic cegs ark files can be generated for end-to-end training tests.

Copy of kaldi_fp16_tpu/io/egs.py (the port imports nothing of the
JAX package); tests/test_torch_egs_io.py holds the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter
from kaldi_fp16_tpu_torch.io.fst import Fst, read_fst, write_fst_compact_acceptor
from kaldi_fp16_tpu_torch.io.matrix import (
    SparseMatrix,
    read_compressed_matrix_cm,
    read_compressed_matrix_cm2,
    read_compressed_matrix_cm3,
    read_full_matrix,
    read_sparse_matrix,
    write_compressed_matrix_cm,
    write_compressed_matrix_cm2,
    write_compressed_matrix_cm3,
    write_full_matrix,
    write_sparse_matrix,
)


@dataclass
class Index:
    """Kaldi nnet3 Index: (n = minibatch index, t = frame, x = extra)."""
    n: int = 0
    t: int = 0
    x: int = 0


@dataclass
class IoBlock:
    name: str
    indexes: List[Index]
    data: np.ndarray          # [rows, cols] float32, decompressed/densified
    fmt: str = "CM"           # storage format used on write: CM/CM2/CM3/FM/SM
    sparse: Optional["SparseMatrix"] = None  # original SM pairs, if fmt="SM"


@dataclass
class Supervision:
    name: str = "output"
    weight: float = 1.0
    num_sequences: int = 1
    frames_per_seq: int = 0
    label_dim: int = 0
    end2end: bool = False
    fst: Optional[Fst] = None
    indexes: List[Index] = field(default_factory=list)
    deriv_weights: Optional[np.ndarray] = None  # float32 [frames]
    deriv_weights_fmt: str = "DW2"              # DW (byte/255) or DW2 (f32)


@dataclass
class Example:
    key: str = ""
    inputs: List[IoBlock] = field(default_factory=list)
    supervision: Supervision = field(default_factory=Supervision)

    def input_named(self, name: str) -> Optional[IoBlock]:
        for io in self.inputs:
            if io.name == name:
                return io
        return None

    @property
    def features(self) -> Optional[np.ndarray]:
        io = self.input_named("input")
        return io.data if io else None

    @property
    def ivector(self) -> Optional[np.ndarray]:
        io = self.input_named("ivector")
        return io.data if io else None

    def validate(self, feat_dim: int = 40, ivector_dim: int = 100,
                 label_dim: int = 3080) -> Tuple[bool, str]:
        """Validation mirroring the reference (parser.go:463-479)."""
        if len(self.inputs) < 1:
            return False, "no inputs"
        feats = self.features
        if feats is None or feats.shape[1] != feat_dim:
            return False, f"input dim != {feat_dim}"
        iv = self.ivector
        if iv is not None and (iv.shape[0] != 1 or iv.shape[1] != ivector_dim):
            return False, f"ivector shape != 1x{ivector_dim}"
        if self.supervision.weight <= 0:
            return False, "weight <= 0"
        if label_dim and self.supervision.label_dim != label_dim:
            return False, f"label_dim != {label_dim}"
        if self.supervision.fst is None and not self.supervision.end2end:
            return False, "missing supervision FST"
        return True, ""


# ---------------------------------------------------------------------------
# Index vector codec
# ---------------------------------------------------------------------------

def read_index_vector(r: BinaryReader, count: int) -> List[Index]:
    out: List[Index] = []
    for i in range(count):
        b = r.read_byte()
        c = b - 256 if b >= 128 else b  # int8
        if c == 127:
            n = r.read_basic_int()
            t = r.read_basic_int()
            x = r.read_basic_int()
            out.append(Index(n, t, x))
        else:
            if i == 0:
                out.append(Index(0, c, 0))
            else:
                last = out[-1]
                out.append(Index(last.n, last.t + c, last.x))
    return out


def write_index_vector(w: BinaryWriter, indexes: List[Index]) -> None:
    prev = Index(0, 0, 0)
    for i, idx in enumerate(indexes):
        ref = prev if i > 0 else Index(0, 0 if i > 0 else 0, 0)
        if i == 0:
            short_ok = idx.n == 0 and idx.x == 0 and abs(idx.t) < 125
            delta = idx.t
        else:
            short_ok = idx.n == prev.n and idx.x == prev.x and abs(idx.t - prev.t) < 125
            delta = idx.t - prev.t
        del ref
        if short_ok:
            w.write_byte(delta & 0xFF)
        else:
            w.write_byte(127)
            for v in (idx.n, idx.t, idx.x):
                w.write_byte(4)
                w.write_int32(v)
        prev = idx


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _is_key_char(b: int) -> bool:
    return (65 <= b <= 90) or (97 <= b <= 122) or (48 <= b <= 57) or b in (45, 95, 46)


def _find_example_start(r: BinaryReader) -> Optional[str]:
    """Scan for 'key \\0B' (ref: parser.go:128-160). Returns key or None at EOF."""
    key = bytearray()
    in_key = False
    while True:
        b = r.try_read_byte()
        if b is None:
            return None
        if not in_key:
            if (65 <= b <= 90) or (97 <= b <= 122):
                in_key = True
                key = bytearray([b])
            continue
        if _is_key_char(b):
            key.append(b)
            continue
        if b == 0x20 and len(key) >= 3:
            b2 = r.try_read_byte()
            if b2 == 0x00:
                b3 = r.try_read_byte()
                if b3 == ord("B"):
                    return key.decode("ascii")
        in_key = False
        key = bytearray()


def _try_read_tag(r: BinaryReader) -> Optional[str]:
    tag = bytearray()
    while True:
        b = r.try_read_byte()
        if b is None:
            return None
        if b == ord(">"):
            break
        if b == 0x20:
            r.unread_byte(b)
            break
        if not (_is_key_char(b) or b == ord("/")):
            return None
        tag.append(b)
        if len(tag) > 30:
            return None
    if len(tag) < 2:
        return None
    return tag.decode("ascii")


def _read_name(r: BinaryReader) -> str:
    b = r.read_byte()
    if b != 0x20:
        r.unread_byte(b)
    name = bytearray()
    while True:
        b = r.try_read_byte()
        if b is None or b == 0x20:
            break
        if b == ord("<"):
            r.unread_byte(b)
            break
        name.append(b)
    return name.decode("ascii")


def _read_deriv_weights(r: BinaryReader, tag: str) -> Optional[np.ndarray]:
    """<DW>: 'FV ' raw-int32 size + bytes/255.  <DW2>: 'FV ' \\x04 int32 + f32s.

    (ref: fst.go:232-267 — DW omits the size byte before the count.)
    """
    b = r.read_byte()  # space after tag
    if b != 0x20:
        r.unread_byte(b)
    fv = r.read_bytes(2)
    if fv != b"FV":
        return None
    r.read_byte()  # space after FV token
    if tag == "DW":
        size = r.read_int32()
        raw = np.frombuffer(r.read_bytes(size), dtype=np.uint8)
        return (raw.astype(np.float32) / np.float32(255.0)).astype(np.float32)
    else:
        sz = r.read_byte()
        if sz != 4:
            raise ValueError(f"DW2: bad size byte {sz}")
        size = r.read_int32()
        raw = np.frombuffer(r.read_bytes(size * 4), dtype="<f4")
        return raw.astype(np.float32)


def _parse_example(r: BinaryReader) -> Example:
    ex = Example()
    current_name = ""
    current_indexes: List[Index] = []
    num_inputs = 0

    while True:
        b = r.read_byte()

        # Matrix tokens appear bare (not inside <>): CM/CM2/CM3/FM/SM
        if b in (ord("C"), ord("F"), ord("S")) and current_name:
            b2 = r.try_read_byte()
            mat = None
            fmt = None
            sparse = None
            if b == ord("S") and b2 == ord("M"):
                b3 = r.read_byte()
                if b3 == 0x20:
                    sparse = read_sparse_matrix(r)
                    mat, fmt = sparse.to_dense(), "SM"
                else:
                    r.unread_byte(b3)
                    continue
            elif b == ord("C") and b2 == ord("M"):
                b3 = r.read_byte()
                if b3 == ord("2"):
                    r.read_byte()  # space
                    mat, fmt = read_compressed_matrix_cm2(r), "CM2"
                elif b3 == ord("3"):
                    r.read_byte()  # space
                    mat, fmt = read_compressed_matrix_cm3(r), "CM3"
                elif b3 == 0x20:
                    mat, fmt = read_compressed_matrix_cm(r), "CM"
                else:
                    r.unread_byte(b3)
                    continue
            elif b == ord("F") and b2 == ord("M"):
                b3 = r.read_byte()
                if b3 == 0x20:
                    mat, fmt = read_full_matrix(r), "FM"
                else:
                    r.unread_byte(b3)
                    continue
            else:
                if b2 is not None:
                    r.unread_byte(b2)
                continue

            if mat is not None:
                ex.inputs.append(IoBlock(name=current_name, indexes=current_indexes,
                                         data=mat, fmt=fmt, sparse=sparse))
                current_name = ""
                current_indexes = []
            continue

        if b != ord("<"):
            continue

        tag = _try_read_tag(r)
        if tag is None:
            continue

        if tag == "NumInputs":
            num_inputs = r.read_basic_int()
        elif tag == "NumOutputs":
            pass_outputs = r.read_basic_int()
            del pass_outputs
        elif tag == "NnetIo":
            current_name = _read_name(r)
        elif tag == "I1V":
            count = r.read_basic_int()
            indexes = read_index_vector(r, count)
            if current_name:
                current_indexes = indexes
            elif ex.supervision.name:
                ex.supervision.indexes = indexes
        elif tag == "/NnetIo":
            current_name = ""
        elif tag == "NnetChainSup":
            ex.supervision.name = _read_name(r)
        elif tag == "Weight":
            ex.supervision.weight = float(np.float32(_read_basic_f32(r)))
        elif tag == "NumSequences":
            ex.supervision.num_sequences = r.read_basic_int()
        elif tag == "FramesPerSeq":
            ex.supervision.frames_per_seq = r.read_basic_int()
        elif tag == "LabelDim":
            ex.supervision.label_dim = r.read_basic_int()
        elif tag == "End2End":
            r.read_byte()  # space
            e2e = r.read_byte()
            ex.supervision.end2end = (e2e == ord("T"))
            if not ex.supervision.end2end:
                fst = read_fst(r)
                if fst is None:
                    raise ValueError("failed to read supervision FST")
                ex.supervision.fst = fst
        elif tag in ("DW", "DW2"):
            ex.supervision.deriv_weights = _read_deriv_weights(r, tag)
            ex.supervision.deriv_weights_fmt = tag
        elif tag == "/Nnet3ChainEg":
            ex.supervision.name = ex.supervision.name or "output"
            del num_inputs
            return ex


def _read_basic_f32(r: BinaryReader) -> float:
    b = r.read_byte()
    if b == 0x20:
        b = r.read_byte()
    if b != 4:
        raise ValueError(f"bad float size byte {b}")
    return r.read_float32()


class EgsReader:
    """Streaming reader over a cegs binary ark file (or .ark.gz)."""

    def __init__(self, path: str):
        self._r = BinaryReader.open(path)

    def close(self) -> None:
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> Example:
        ex = self.read_example()
        if ex is None:
            raise StopIteration
        return ex

    def read_example(self) -> Optional[Example]:
        key = _find_example_start(self._r)
        if key is None:
            return None
        ex = _parse_example(self._r)
        ex.key = key
        return ex


def read_examples(path: str, limit: Optional[int] = None) -> List[Example]:
    out = []
    with EgsReader(path) as r:
        for ex in r:
            out.append(ex)
            if limit is not None and len(out) >= limit:
                break
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_MATRIX_WRITERS = {
    "CM": write_compressed_matrix_cm,
    "CM2": write_compressed_matrix_cm2,
    "CM3": write_compressed_matrix_cm3,
    "FM": write_full_matrix,
    "SM": write_sparse_matrix,
}


def count_examples(path: str) -> int:
    """Count examples by scanning for the '\\0B<Nnet3ChainEg>' record marker
    without decoding anything — for LR-schedule sizing, a full parse of a
    73 GB dataset just to count batches would double time-to-first-step."""
    import gzip
    marker = b"\x00B<Nnet3ChainEg>"
    opener = gzip.open if path.endswith(".gz") else open
    n = 0
    tail = b""
    with opener(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            buf = tail + chunk
            n += buf.count(marker)
            tail = buf[-(len(marker) - 1):]
    return n


def write_example(w: BinaryWriter, ex: Example) -> None:
    """Emit one 'key \\0B<Nnet3ChainEg>...' record."""
    key = ex.key or "eg-0"
    if len(key) < 3:
        # the reader's record-header scan requires keys of >= 3 chars
        # (egs.py read path); shorter keys would write unreadable arks
        raise ValueError(f"ark key too short (< 3 chars): {key!r}")
    w.write_ark_record_header(key)
    w.write_token("<Nnet3ChainEg>")
    w.write_token("<NumInputs>")
    # token already wrote the space; WriteBasicType adds size byte + payload
    w.write_byte(4)
    w.write_int32(len(ex.inputs))
    for io in ex.inputs:
        w.write_token("<NnetIo>")
        w.write_token(io.name)
        w.write_token("<I1V>")
        w.write_byte(4)
        w.write_int32(len(io.indexes))
        write_index_vector(w, io.indexes)
        if io.fmt == "SM":
            # preserve the original pairs (order/explicit zeros) if present
            write_sparse_matrix(w, io.sparse if io.sparse is not None
                                else io.data)
        else:
            _MATRIX_WRITERS[io.fmt](w, io.data)
        w.write_token("</NnetIo>")

    sup = ex.supervision
    w.write_token("<NumOutputs>")
    w.write_byte(4)
    w.write_int32(1)
    w.write_token("<NnetChainSup>")
    w.write_token(sup.name)
    w.write_token("<I1V>")
    w.write_byte(4)
    w.write_int32(len(sup.indexes))
    write_index_vector(w, sup.indexes)

    w.write_token("<Supervision>")
    w.write_token("<Weight>")
    w.write_byte(4)
    w.write_float32(sup.weight)
    w.write_token("<NumSequences>")
    w.write_byte(4)
    w.write_int32(sup.num_sequences)
    w.write_token("<FramesPerSeq>")
    w.write_byte(4)
    w.write_int32(sup.frames_per_seq)
    w.write_token("<LabelDim>")
    w.write_byte(4)
    w.write_int32(sup.label_dim)
    w.write_token("<End2End>")
    w.write_bytes(b"T" if sup.end2end else b"F")
    if not sup.end2end:
        assert sup.fst is not None, "non-e2e supervision requires an FST"
        write_fst_compact_acceptor(w, sup.fst)
    w.write_token("</Supervision>")

    if sup.deriv_weights is not None:
        dw = np.asarray(sup.deriv_weights, dtype=np.float32)
        if sup.deriv_weights_fmt == "DW":
            w.write_token("<DW>")
            w.write_token("FV")
            w.write_int32(len(dw))  # note: raw int32, no size byte (ref fst.go:243)
            w.write_bytes(np.clip(np.floor(dw * 255.0 + 0.5), 0, 255)
                          .astype(np.uint8).tobytes())
        else:
            w.write_token("<DW2>")
            w.write_token("FV")
            w.write_byte(4)
            w.write_int32(len(dw))
            w.write_bytes(dw.astype("<f4").tobytes())
    w.write_token("</NnetChainSup>")
    w.write_token("</Nnet3ChainEg>")


def write_ark(path: str, examples: List[Example]) -> None:
    w = BinaryWriter()
    for ex in examples:
        write_example(w, ex)
    with open(path, "wb") as f:
        f.write(w.getvalue())


# ---------------------------------------------------------------------------
# Text emitter (the 'egstools totext' analog; ref cmd/egstools/main.go totext)
# ---------------------------------------------------------------------------

def _indexes_to_text(indexes: List[Index]) -> str:
    return " ".join(f"({i.n},{i.t},{i.x})" for i in indexes)


def _matrix_to_text(data: np.ndarray) -> str:
    rows = []
    for r_ in data:
        rows.append("  " + " ".join(f"{v:.6g}" for v in r_))
    return " [\n" + "\n".join(rows) + " ]"


def example_to_text(ex: Example) -> str:
    """Human/diff-friendly text rendering of an example (Kaldi text-form style)."""
    parts = [f"{ex.key} <Nnet3ChainEg> <NumInputs> {len(ex.inputs)}"]
    for io in ex.inputs:
        parts.append(f"<NnetIo> {io.name} {_indexes_to_text(io.indexes)}")
        parts.append(_matrix_to_text(io.data))
        parts.append("</NnetIo>")
    sup = ex.supervision
    parts.append("<NumOutputs> 1")
    parts.append(f"<NnetChainSup> {sup.name} {_indexes_to_text(sup.indexes)}")
    parts.append(f"<Supervision> <Weight> {sup.weight:.6g} "
                 f"<NumSequences> {sup.num_sequences} "
                 f"<FramesPerSeq> {sup.frames_per_seq} "
                 f"<LabelDim> {sup.label_dim} "
                 f"<End2End> {'T' if sup.end2end else 'F'}")
    if sup.fst is not None:
        arc_lines = []
        for s, st in enumerate(sup.fst.states):
            for a in st.arcs:
                arc_lines.append(f"{s} {a.next_state} {a.label} {a.weight:.6g}")
            if st.is_final:
                arc_lines.append(f"{s} {st.final:.6g}")
        parts.append("\n".join(arc_lines))
    parts.append("</Supervision>")
    if sup.deriv_weights is not None:
        parts.append("<DW2> [ " + " ".join(f"{v:.6g}" for v in sup.deriv_weights) + " ]")
    parts.append("</NnetChainSup> </Nnet3ChainEg>")
    return "\n".join(parts)
