"""Kaldi's compressed-matrix formats, as the egs hold the features.

A frozen copy of the codec of kaldi_fp16_tpu_torch/io/matrix.py at commit
de5aca0 (Kaldi's CompressedMatrix: "CM", per-column percentile headers and
one byte a value; "CM2", two bytes a value on a global range), as array
round trips: what a reader of a matrix written in that format gets back.
The reference works the features out again through it from the
generator's values.
"""

from __future__ import annotations

import numpy as np

_INV_65535 = np.float32(1.52590218966964e-05)  # matches reference matrix.go:12


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

def _global_min_range(data: np.ndarray):
    gmin = float(data.min())
    gmax = float(data.max())
    grange = gmax - gmin
    if grange <= 0:
        grange = 1.0
    return gmin, grange


def cm_round_trip(data: np.ndarray) -> np.ndarray:
    """A [rows, cols] matrix written as "CM" and read back."""
    data = np.asarray(data, dtype=np.float32)
    rows, cols = data.shape
    gmin, grange = _global_min_range(data)
    out = np.empty((rows, cols), np.float32)
    for c in range(cols):
        q = _column_percentiles(data[:, c], gmin, grange)
        pf = uint16_to_float(np.float32(gmin), np.float32(grange),
                             np.array(q, dtype=np.uint16))
        byte = _float_to_char(float(pf[0]), float(pf[1]), float(pf[2]),
                              float(pf[3]), data[:, c])
        # the reader decodes with the header's values read back as float32
        out[:, c] = char_to_float(pf[0:1], pf[1:2], pf[2:3], pf[3:4], byte)
    return out


def cm2_round_trip(data: np.ndarray) -> np.ndarray:
    """A matrix written as "CM2" and read back."""
    data = np.asarray(data, dtype=np.float32)
    gmin, grange = _global_min_range(data)
    q = _float_to_uint16(gmin, grange, data)
    increment = np.float32(np.float32(grange)) / np.float32(65535.0)
    return (np.float32(gmin) + q.astype(np.float32) * increment
            ).astype(np.float32)
