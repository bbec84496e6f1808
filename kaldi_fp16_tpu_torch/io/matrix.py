"""Kaldi CompressedMatrix / Matrix codecs.

Decoders are bit-faithful ports of the reference decode math
(ref: internal/parser/matrix.go:11-170; Kaldi
src/matrix/compressed-matrix.cc semantics):

  CM  (kOneByteWithColHeaders): 16-byte global header (min f32, range f32,
      rows i32, cols i32 — the format id lives in the token, so no 20-byte
      header), then cols x 4 uint16 percentiles (p0,p25,p75,p100), then
      rows*cols bytes of data in COLUMN-major order.  Decode is a piecewise
      linear map per column; the value>192 branch multiplies in float32 but
      divides in float64 to match Kaldi bit-exactly
      (ref: matrix.go:17-26, docs/CM_DECOMPRESSION_FIX.md).
  CM2 (kTwoByte):  global header + rows*cols uint16, ROW-major.
  CM3 (kOneByte):  global header + rows*cols uint8, ROW-major.
  FM  (full):      '\\x04' rows '\\x04' cols + rows*cols float32 row-major.
      (Note: the reference Go reader consumes only a single size byte before
      rows and cols — a latent deviation from Kaldi's WriteBasicType framing
      that never fired because FM does not occur in its dataset.  We follow
      real Kaldi: one size byte before EACH integer.)
  SM  (sparse):    num_rows, then per row 'SV' + dim + num_elems +
      (index, value) pairs (ref: matrix.go:172-226, sm_parse_test.go).
      The reference reads a SPACE before every WriteBasicType payload (its
      fixtures encode ' ' + size + data), while real Kaldi's WriteBasicType
      emits no space — only tokens ('SM ', 'SV ') carry one.  Our reader is
      tolerant: it skips one optional 0x20 before each size byte (0x20 is
      not a valid size, so this is unambiguous) and therefore parses both
      encodings; the writer emits real-Kaldi framing.

Encoders exist so that tests can generate Kaldi-format files and verify the
decoders by round-trip; they follow Kaldi's percentile-based compression
scheme but are not required to be bit-identical to Kaldi's encoder.

Copy of kaldi_fp16_tpu/io/matrix.py (the port imports nothing of the
JAX package); tests/test_torch_egs_io.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter

_INV_65535 = np.float32(1.52590218966964e-05)  # matches reference matrix.go:12


# ---------------------------------------------------------------------------
# Decode primitives (bit-faithful float32/float64 op ordering)
# ---------------------------------------------------------------------------

def uint16_to_float(global_min: np.float32, global_range: np.float32,
                    value: np.ndarray) -> np.ndarray:
    """percentile = min + range * (1/65535) * value, all in float32."""
    gmin = np.float32(global_min)
    grange = np.float32(global_range)
    return (gmin + grange * _INV_65535 * value.astype(np.float32)).astype(np.float32)


def char_to_float(p0: np.ndarray, p25: np.ndarray, p75: np.ndarray,
                  p100: np.ndarray, value: np.ndarray) -> np.ndarray:
    """Piecewise-linear decode of one data byte given column percentiles.

    value, p* may broadcast (value: [rows, cols], p*: [cols]).
    Branch boundaries and op order match reference matrix.go:17-26:
      <=64:   p0  + (p25-p0)  * v        * (1/64)
      <=192:  p25 + (p75-p25) * (v-64)   * (1/128)
      else:   f32( f64(p75) + f64((p100-p75) * f32(v-192)) / 63.0 )
    """
    v = value.astype(np.float32)
    p0 = p0.astype(np.float32)
    p25 = p25.astype(np.float32)
    p75 = p75.astype(np.float32)
    p100 = p100.astype(np.float32)

    b1 = (p0 + (p25 - p0) * v * np.float32(1.0 / 64.0)).astype(np.float32)
    b2 = (p25 + (p75 - p25) * (v - np.float32(64.0)) * np.float32(1.0 / 128.0)).astype(np.float32)
    # branch 3: multiply in fp32, divide in fp64 (Kaldi quirk)
    m32 = ((p100 - p75) * (v - np.float32(192.0))).astype(np.float32)
    b3 = (p75.astype(np.float64) + m32.astype(np.float64) / 63.0).astype(np.float32)

    byte = value  # integer dtype for branch selection
    return np.where(byte <= 64, b1, np.where(byte <= 192, b2, b3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Encode primitives
# ---------------------------------------------------------------------------

def _float_to_uint16(global_min: float, global_range: float, value: np.ndarray) -> np.ndarray:
    f = (value - global_min) / global_range
    return np.clip(np.floor(f * 65535.0 + 0.5), 0, 65535).astype(np.uint16)


def _float_to_char(p0, p25, p75, p100, value: np.ndarray) -> np.ndarray:
    """Inverse of char_to_float (Kaldi FloatToChar semantics, vectorized)."""
    out = np.empty(value.shape, dtype=np.uint8)
    v = value.astype(np.float64)

    lo = v < p25
    hi = v >= p75
    mid = ~(lo | hi)

    with np.errstate(divide="ignore", invalid="ignore"):
        f_lo = np.where(p25 > p0, (v - p0) / (p25 - p0), 0.0)
        c_lo = np.clip(np.floor(f_lo * 64.0 + 0.5), 0, 64)
        f_mid = np.where(p75 > p25, (v - p25) / (p75 - p25), 0.0)
        c_mid = np.clip(np.floor(64.0 + f_mid * 128.0 + 0.5), 64, 192)
        f_hi = np.where(p100 > p75, (v - p75) / (p100 - p75), 0.0)
        c_hi = np.clip(np.floor(192.0 + f_hi * 63.0 + 0.5), 192, 255)

    out[lo] = c_lo[lo].astype(np.uint8)
    out[mid] = c_mid[mid].astype(np.uint8)
    out[hi] = c_hi[hi].astype(np.uint8)
    return out


def _column_percentiles(col: np.ndarray, global_min: float, global_range: float):
    """Kaldi-style per-column percentiles as uint16, strictly increasing."""
    n = len(col)
    s = np.sort(col)
    q0 = _float_to_uint16(global_min, global_range, s[0:1])[0]
    q25 = _float_to_uint16(global_min, global_range, s[n // 4: n // 4 + 1])[0]
    q75 = _float_to_uint16(global_min, global_range, s[(3 * n) // 4: (3 * n) // 4 + 1])[0]
    q100 = _float_to_uint16(global_min, global_range, s[n - 1: n])[0]
    # enforce strict ordering like Kaldi ComputeColHeader
    q25 = min(max(q25, q0 + 1), 65533)
    q75 = min(max(q75, q25 + 1), 65534)
    q100 = max(q100, q75 + 1)
    return int(q0), int(q25), int(min(q75, 65534)), int(min(q100, 65535))


# ---------------------------------------------------------------------------
# Readers (header min/range/rows/cols already consumed by the egs parser when
# embedded; the standalone functions below consume the full payload after the
# format token).
# ---------------------------------------------------------------------------

def _read_global_header(r: BinaryReader):
    gmin = np.float32(r.read_float32())
    grange = np.float32(r.read_float32())
    rows = r.read_int32()
    cols = r.read_int32()
    if rows <= 0 or cols <= 0 or rows > 100000 or cols > 10000:
        raise ValueError(f"bad compressed-matrix dims {rows}x{cols}")
    return gmin, grange, rows, cols


def read_compressed_matrix_cm(r: BinaryReader) -> np.ndarray:
    """Read CM payload (after 'CM ' token): header + col headers + col-major bytes."""
    gmin, grange, rows, cols = _read_global_header(r)
    hdr = np.frombuffer(r.read_bytes(cols * 8), dtype="<u2").reshape(cols, 4)
    p = uint16_to_float(gmin, grange, hdr)  # [cols, 4]
    raw = np.frombuffer(r.read_bytes(rows * cols), dtype=np.uint8)
    data_cm = raw.reshape(cols, rows)  # column-major input
    # decode per column, output row-major [rows, cols]
    out = char_to_float(p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4], data_cm)
    return np.ascontiguousarray(out.T)


def read_compressed_matrix_cm2(r: BinaryReader) -> np.ndarray:
    gmin, grange, rows, cols = _read_global_header(r)
    raw = np.frombuffer(r.read_bytes(rows * cols * 2), dtype="<u2")
    increment = np.float32(grange) / np.float32(65535.0)
    out = (np.float32(gmin) + raw.astype(np.float32) * increment).astype(np.float32)
    return out.reshape(rows, cols)


def read_compressed_matrix_cm3(r: BinaryReader) -> np.ndarray:
    gmin, grange, rows, cols = _read_global_header(r)
    raw = np.frombuffer(r.read_bytes(rows * cols), dtype=np.uint8)
    increment = np.float32(grange) / np.float32(255.0)
    out = (np.float32(gmin) + raw.astype(np.float32) * increment).astype(np.float32)
    return out.reshape(rows, cols)


def read_full_matrix(r: BinaryReader) -> np.ndarray:
    """Read FM payload (after 'FM ' token): \\x04 rows \\x04 cols + f32 data."""
    sz = r.read_byte()
    if sz != 4:
        raise ValueError(f"FM: bad rows size byte {sz}")
    rows = r.read_int32()
    sz = r.read_byte()
    if sz != 4:
        raise ValueError(f"FM: bad cols size byte {sz}")
    cols = r.read_int32()
    if rows <= 0 or cols <= 0:
        raise ValueError(f"FM: bad dims {rows}x{cols}")
    raw = np.frombuffer(r.read_bytes(rows * cols * 4), dtype="<f4")
    return raw.reshape(rows, cols).astype(np.float32)


# ---------------------------------------------------------------------------
# Sparse matrix (SM / SV)
# ---------------------------------------------------------------------------

class SparseMatrix:
    """Kaldi SparseMatrix: one SparseVector per row.

    rows: list of (dim, idx int32 [k], val float32 [k]) triples, preserving
    the stored pair order (which real Kaldi keeps sorted by index but the
    format does not require).
    """

    def __init__(self, rows):
        self.rows = list(rows)

    @property
    def num_rows(self) -> int:
        return len(self.rows)

    @property
    def num_cols(self) -> int:
        return max((d for d, _, _ in self.rows), default=0)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_rows, self.num_cols), np.float32)
        for r, (_, idx, val) in enumerate(self.rows):
            np.add.at(out[r], idx, val)   # duplicate indices accumulate
        return out

    @classmethod
    def from_dense(cls, data: np.ndarray) -> "SparseMatrix":
        data = np.asarray(data, np.float32)
        rows = []
        for r in range(data.shape[0]):
            idx = np.nonzero(data[r])[0].astype(np.int32)
            rows.append((data.shape[1], idx,
                         data[r, idx].astype(np.float32)))
        return cls(rows)


def _read_basic_int32_sp(r: BinaryReader) -> int:
    """WriteBasicType<int32>, tolerating one optional leading space (the
    reference's space-padded framing AND real Kaldi's bare framing)."""
    b = r.read_byte()
    if b == 0x20:
        b = r.read_byte()
    if b != 4:
        raise ValueError(f"sparse: bad int32 size byte {b}")
    return r.read_int32()


def _read_basic_float32_sp(r: BinaryReader) -> float:
    b = r.read_byte()
    if b == 0x20:
        b = r.read_byte()
    if b != 4:
        raise ValueError(f"sparse: bad float32 size byte {b}")
    return r.read_float32()


def read_sparse_matrix(r: BinaryReader) -> SparseMatrix:
    """Read SM payload (after the 'SM' token; the token's trailing space is
    absorbed by the first tolerant basic read)."""
    num_rows = _read_basic_int32_sp(r)
    if num_rows < 0 or num_rows > 10_000_000:
        raise ValueError(f"SM: bad num_rows {num_rows}")
    rows = []
    for _ in range(num_rows):
        b1, b2 = r.read_byte(), r.read_byte()
        if (b1, b2) != (ord("S"), ord("V")):
            raise ValueError(
                f"SM: expected 'SV' row token, got {bytes([b1, b2])!r}")
        dim = _read_basic_int32_sp(r)
        n = _read_basic_int32_sp(r)
        if dim < 0 or n < 0 or n > dim:
            raise ValueError(f"SV: bad dim/num_elems {dim}/{n}")
        idx = np.empty(n, np.int32)
        val = np.empty(n, np.float32)
        for i in range(n):
            idx[i] = _read_basic_int32_sp(r)
            val[i] = _read_basic_float32_sp(r)
        if n and (idx.min() < 0 or idx.max() >= dim):
            raise ValueError("SV: pair index out of range")
        rows.append((dim, idx, val))
    return SparseMatrix(rows)


def write_sparse_matrix(w: BinaryWriter, data) -> None:
    """Emit 'SM ' + payload in real-Kaldi framing (no spaces before basic
    types; tokens carry their usual trailing space)."""
    sm = data if isinstance(data, SparseMatrix) else SparseMatrix.from_dense(data)
    w.write_token("SM")
    w.write_byte(4)
    w.write_int32(sm.num_rows)
    for dim, idx, val in sm.rows:
        w.write_bytes(b"SV ")
        w.write_byte(4)
        w.write_int32(int(dim))
        w.write_byte(4)
        w.write_int32(len(idx))
        for i, v in zip(idx, val):
            w.write_byte(4)
            w.write_int32(int(i))
            w.write_byte(4)
            w.write_float32(float(v))


# ---------------------------------------------------------------------------
# Writers (emit token + payload)
# ---------------------------------------------------------------------------

def _write_global_header(w: BinaryWriter, gmin: float, grange: float, rows: int, cols: int):
    w.write_float32(float(gmin))
    w.write_float32(float(grange))
    w.write_int32(rows)
    w.write_int32(cols)


def _global_min_range(data: np.ndarray):
    gmin = float(data.min())
    gmax = float(data.max())
    grange = gmax - gmin
    if grange <= 0:
        grange = 1.0
    return gmin, grange


def write_compressed_matrix_cm(w: BinaryWriter, data: np.ndarray) -> None:
    """Emit 'CM ' + header + per-col percentile headers + col-major bytes."""
    data = np.asarray(data, dtype=np.float32)
    rows, cols = data.shape
    gmin, grange = _global_min_range(data)
    w.write_token("CM")
    _write_global_header(w, gmin, grange, rows, cols)

    headers_u16 = np.empty((cols, 4), dtype="<u2")
    byte_cols = np.empty((cols, rows), dtype=np.uint8)
    for c in range(cols):
        q = _column_percentiles(data[:, c], gmin, grange)
        headers_u16[c] = q
        pf = uint16_to_float(np.float32(gmin), np.float32(grange),
                             np.array(q, dtype=np.uint16))
        byte_cols[c] = _float_to_char(float(pf[0]), float(pf[1]), float(pf[2]),
                                      float(pf[3]), data[:, c])
    w.write_bytes(headers_u16.tobytes())
    w.write_bytes(byte_cols.tobytes())  # column-major


def write_compressed_matrix_cm2(w: BinaryWriter, data: np.ndarray) -> None:
    data = np.asarray(data, dtype=np.float32)
    rows, cols = data.shape
    gmin, grange = _global_min_range(data)
    w.write_token("CM2")
    _write_global_header(w, gmin, grange, rows, cols)
    q = _float_to_uint16(gmin, grange, data).astype("<u2")
    w.write_bytes(q.tobytes())


def write_compressed_matrix_cm3(w: BinaryWriter, data: np.ndarray) -> None:
    data = np.asarray(data, dtype=np.float32)
    rows, cols = data.shape
    gmin, grange = _global_min_range(data)
    w.write_token("CM3")
    _write_global_header(w, gmin, grange, rows, cols)
    f = np.clip(np.floor((data - gmin) / grange * 255.0 + 0.5), 0, 255)
    w.write_bytes(f.astype(np.uint8).tobytes())


def write_full_matrix(w: BinaryWriter, data: np.ndarray) -> None:
    data = np.asarray(data, dtype=np.float32)
    rows, cols = data.shape
    w.write_token("FM")
    w.write_byte(4)
    w.write_int32(rows)
    w.write_byte(4)
    w.write_int32(cols)
    w.write_bytes(data.astype("<f4").tobytes())
