"""Low-level Kaldi binary stream primitives.

Implements the byte-level conventions of Kaldi's binary I/O
(ref: internal/parser/parser.go:305-460 for the read side;
Kaldi src/base/io-funcs.cc semantics for the write side):

  * "key \\0B"        — binary ark record marker (space, NUL, 'B')
  * "<Tag> "          — tokens are ASCII followed by one space
  * WriteBasicType    — 1 size byte (1/4/8) then little-endian payload
  * float32/float64   — raw little-endian, no size byte in matrix payloads

Both a reader and a writer are provided: the writer lets the test-suite
generate bit-faithful Kaldi files so parser round-trips can be verified
without access to real Kaldi data.

Copy of kaldi_fp16_tpu/io/kaldi_io.py (the port imports nothing of the
JAX package); tests/test_torch_egs_io.py holds the two equal.
"""

from __future__ import annotations

import gzip
import io
import struct
from typing import BinaryIO, Optional, Union


class BinaryReader:
    """Buffered reader over a Kaldi binary stream with 1-byte lookahead."""

    def __init__(self, src: Union[bytes, BinaryIO]):
        if isinstance(src, (bytes, bytearray)):
            self._f: BinaryIO = io.BytesIO(bytes(src))
        else:
            self._f = src
        self._pushback: list = []

    @classmethod
    def open(cls, path: str) -> "BinaryReader":
        if path.endswith(".gz"):
            return cls(gzip.open(path, "rb"))
        return cls(open(path, "rb"))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- byte-level --------------------------------------------------------

    def read_byte(self) -> int:
        """Read one byte; raises EOFError at end of stream."""
        if self._pushback:
            return self._pushback.pop()
        data = self._f.read(1)
        if not data:
            raise EOFError("unexpected EOF")
        return data[0]

    def try_read_byte(self) -> Optional[int]:
        try:
            return self.read_byte()
        except EOFError:
            return None

    def unread_byte(self, b: int) -> None:
        """Push a byte back; LIFO, multi-byte lookahead supported (the
        nnet3 binary reader peeks 3-byte matrix/vector markers)."""
        self._pushback.append(b)

    def peek_byte(self) -> Optional[int]:
        b = self.try_read_byte()
        if b is not None:
            self.unread_byte(b)
        return b

    def read_bytes(self, n: int) -> bytes:
        out = bytearray()
        while self._pushback and len(out) < n:
            out.append(self._pushback.pop())
        while len(out) < n:
            chunk = self._f.read(n - len(out))
            if not chunk:
                raise EOFError(f"unexpected EOF after {len(out)}/{n} bytes")
            out.extend(chunk)
        return bytes(out)

    # -- scalars -----------------------------------------------------------

    def read_int32(self) -> int:
        return struct.unpack("<i", self.read_bytes(4))[0]

    def read_uint32(self) -> int:
        return struct.unpack("<I", self.read_bytes(4))[0]

    def read_int64(self) -> int:
        return struct.unpack("<q", self.read_bytes(8))[0]

    def read_uint64(self) -> int:
        return struct.unpack("<Q", self.read_bytes(8))[0]

    def read_float32(self) -> float:
        return struct.unpack("<f", self.read_bytes(4))[0]

    def read_float64(self) -> float:
        return struct.unpack("<d", self.read_bytes(8))[0]

    def read_basic_int(self) -> int:
        """Kaldi ReadBasicType<int32>: space already consumed by caller?  No —
        the reference consumes a leading space then a size byte
        (parser.go:readBasicIntValue).  This method consumes 'space, size, payload'.
        """
        b = self.read_byte()
        if b == 0x20:  # leading space
            b = self.read_byte()
        size = b
        if size == 1:
            return struct.unpack("<b", self.read_bytes(1))[0]
        if size == 4:
            return self.read_int32()
        if size == 8:
            return self.read_int64()
        raise ValueError(f"unsupported basic-type size byte {size}")

    def read_basic_float(self) -> float:
        """Kaldi ReadBasicType<BaseFloat>: space, size byte (4), float payload."""
        b = self.read_byte()
        if b == 0x20:
            b = self.read_byte()
        if b == 4:
            return self.read_float32()
        if b == 8:
            return self.read_float64()
        raise ValueError(f"unsupported float size byte {b}")

    # -- tokens ------------------------------------------------------------

    def read_token(self) -> str:
        """Read an ASCII token up to (and consuming) the trailing space."""
        out = bytearray()
        while True:
            b = self.read_byte()
            if b == 0x20:
                break
            out.append(b)
        return out.decode("ascii")

    def expect_token(self, tok: str) -> None:
        got = self.read_token()
        if got != tok:
            raise ValueError(f"expected token {tok!r}, got {got!r}")


class BinaryWriter:
    """Writer emitting Kaldi binary-mode conventions (the inverse of BinaryReader)."""

    def __init__(self, dst: Optional[BinaryIO] = None):
        self._f: BinaryIO = dst if dst is not None else io.BytesIO()

    def getvalue(self) -> bytes:
        assert isinstance(self._f, io.BytesIO)
        return self._f.getvalue()

    def write_bytes(self, data: bytes) -> None:
        self._f.write(data)

    def write_byte(self, b: int) -> None:
        self._f.write(bytes([b]))

    def write_int32(self, v: int) -> None:
        self._f.write(struct.pack("<i", v))

    def write_uint32(self, v: int) -> None:
        self._f.write(struct.pack("<I", v))

    def write_int64(self, v: int) -> None:
        self._f.write(struct.pack("<q", v))

    def write_uint64(self, v: int) -> None:
        self._f.write(struct.pack("<Q", v))

    def write_float32(self, v: float) -> None:
        self._f.write(struct.pack("<f", v))

    def write_float64(self, v: float) -> None:
        self._f.write(struct.pack("<d", v))

    def write_basic_int(self, v: int, with_space: bool = True) -> None:
        """Kaldi WriteBasicType<int32> in binary mode: size byte + payload.

        Kaldi always writes int32 as 4 bytes (it does not shrink to 1 byte);
        the 1-byte form appears only for char-typed values.  A leading space
        is written because callers emit '<Tag> ' + value.
        """
        if with_space:
            self.write_byte(0x20)
        self.write_byte(4)
        self.write_int32(v)

    def write_basic_float(self, v: float, with_space: bool = True) -> None:
        if with_space:
            self.write_byte(0x20)
        self.write_byte(4)
        self.write_float32(v)

    def write_token(self, tok: str) -> None:
        """Write token followed by the single mandatory space."""
        self._f.write(tok.encode("ascii"))
        self.write_byte(0x20)

    def write_ark_record_header(self, key: str) -> None:
        """'key \\0B' — the binary ark record marker."""
        self._f.write(key.encode("ascii"))
        self.write_byte(0x20)
        self.write_byte(0x00)
        self._f.write(b"B")
