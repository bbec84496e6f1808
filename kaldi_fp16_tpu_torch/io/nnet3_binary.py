"""Kaldi BINARY nnet3 model files (.mdl / .raw) — standalone read/write.

The reference imports trained models by shelling out to a full Kaldi
install (`nnet3-copy --binary=false final.mdl -`, weight_loader.go:605-613)
and parsing the text.  Here the binary container is handled directly, so
a real `final.mdl` loads with no Kaldi installed.

Layout of a binary .mdl (kaldi/src/nnet3/nnet-nnet.cc Nnet::Write,
hmm/transition-model.cc):

    \\0B                                   binary header
    <TransitionModel> ... </TransitionModel>   (absent in .raw files)
    <Nnet3> \\n
    <text config lines: input-node/component-node/output-node...> \\n
    \\n                                    blank line ends the config
    <NumComponents> [int32]
    <ComponentName> [name] <ClassName> ...component data... </ClassName>
      (x NumComponents)
    </Nnet3>

Notes on fidelity:
  * Token/basic-type/FV/FM primitives follow Kaldi io-funcs exactly
    (size-prefixed scalars, 'T'/'F' bools, float32 "FV"/"FM" and float64
    "DV"/"DM" markers) — the same grammar the cegs parser (io/kaldi_io.py)
    decodes byte-exactly against real ark files.
  * The TransitionModel block is preserved OPAQUELY (byte-for-byte) and
    round-trips unchanged; decoding its tuples into a transition-id ->
    pdf-id map is not attempted (the chain pipeline needs only the nnet).
  * Component payloads are parsed with a tag-driven reader: matrix/vector
    markers are self-describing; sized scalars are typed by the same tag
    tables the text loader uses (models/kaldi_loader.py) plus a
    float-plausibility heuristic for unknown tags; integer-vector tags
    (Kaldi WriteIntegerVector: sized count + raw int32 block, e.g.
    <TimeOffsets>/<RequiredTimeOffsets>) are table-driven.  Items are
    recorded and re-written in SOURCE ORDER, so read->write of a foreign
    component preserves Kaldi's ExpectToken sequencing.
  * Known lossy case: float64 payloads ("DV"/"DM" and 8-byte scalars)
    are held as float32/float in memory; "DV"/"DM" re-write as "FV"/"FM"
    (model parameters are BaseFloat=float32 in practice).

Copy of kaldi_fp16_tpu/io/nnet3_binary.py (the port imports nothing of
the JAX package); tests/test_torch_nnet3_binary.py holds the two equal.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter


# tags whose payload is WriteBasicType<bool> ('T'/'F', no size byte)
_BOOL_TAGS = {
    "<IsGradient>", "<UseNaturalGradient>", "<IsUpdatable>", "<TestMode>",
}

# int-valued tags (4-byte payloads that must NOT be read as float).
# NOTE <NumSamplesHistory> is a BaseFloat in Kaldi (OnlineNaturalGradient)
# — deliberately NOT here.
_INT_TAGS = {
    "<Dim>", "<InputDim>", "<OutputDim>", "<BlockDim>", "<NumFiltersIn>",
    "<NumFiltersOut>", "<HeightIn>", "<HeightOut>", "<NumHeads>",
    "<KeyDim>", "<ValueDim>", "<RankIn>", "<RankOut>", "<Rank>",
    "<UpdatePeriod>", "<NumRepeats>", "<NumBlocks>",
    # first value of Kaldi's two-int <RankInOut> (the second, untagged
    # int is typed by the payload heuristic)
    "<RankInOut>",
}

# tags whose payload is Kaldi WriteIntegerVector: sized count then the
# RAW int32 array (no per-element size bytes)
_INTVEC_TAGS = {
    "<TimeOffsets>", "<RequiredTimeOffsets>", "<Context>",
    "<ColumnMap>", "<Sizes>", "<Pdfs>",
}

# tags whose payload is Kaldi WriteIntegerPairVector: sized count = the
# number of PAIRS, then 2*count raw int32s (kaldi io-funcs-inl.h; used
# by ConvolutionModel's (time, height) offset list — convolution.cc).
# Stored flat [t0, h0, t1, h1, ...] with kind 'intpairvec' so the writer
# re-emits the pair-vector framing, not a flat WriteIntegerVector.
_INTPAIRVEC_TAGS = {
    "<Offsets>",
}


@dataclass
class BinaryComponent:
    """One parsed component: class name + payload ITEMS in read order.

    `items` is the source of truth — a list of (tag, kind, value) where
    tag may be None for a payload with no preceding tag, and kind is one
    of 'int', 'float', 'double', 'bool', 'vector', 'matrix', 'intvec',
    'flag'.  The typed dict properties are convenience views; the writer
    replays `items` verbatim so read->write preserves the original tag
    order (Kaldi component readers are ExpectToken-sequenced, and
    reordering would also break byte-stable round-trips)."""
    name: str = ""
    type: str = ""                       # class token without <>
    items: List[Tuple[Optional[str], str, object]] = field(
        default_factory=list)

    def _view(self, kinds):
        """Read-only view: item assignment must go through set_* (a plain
        dict here would silently discard `comp.ints['<Dim>'] = v`)."""
        import types
        return types.MappingProxyType(
            {tag: v for tag, k, v in self.items
             if tag is not None and k in kinds})

    @property
    def scalars(self) -> Dict[str, float]:
        return self._view(("float", "double"))

    @property
    def ints(self) -> Dict[str, int]:
        return self._view(("int",))

    @property
    def bools(self) -> Dict[str, bool]:
        return self._view(("bool",))

    @property
    def matrices(self) -> Dict[str, np.ndarray]:
        return self._view(("matrix",))

    @property
    def vectors(self) -> Dict[str, np.ndarray]:
        return self._view(("vector",))

    @property
    def int_vectors(self) -> Dict[str, np.ndarray]:
        # pair vectors are exposed flat [t0, h0, t1, h1, ...] — the
        # consumers (to_kaldi_components) re-pair them
        return self._view(("intvec", "intpairvec"))

    @property
    def flags(self) -> Tuple[str, ...]:
        return tuple(tag for tag, k, _ in self.items if k == "flag")

    # -- helpers for constructing components programmatically -----------
    def set_int(self, tag: str, v: int) -> None:
        self.items.append((tag, "int", int(v)))

    def set_float(self, tag: str, v: float) -> None:
        self.items.append((tag, "float", float(v)))

    def set_bool(self, tag: str, v: bool) -> None:
        self.items.append((tag, "bool", bool(v)))

    def set_vector(self, tag: str, v: np.ndarray) -> None:
        self.items.append((tag, "vector", np.asarray(v, np.float32)))

    def set_matrix(self, tag: str, v: np.ndarray) -> None:
        self.items.append((tag, "matrix", np.asarray(v, np.float32)))

    def set_intvec(self, tag: str, v: np.ndarray) -> None:
        self.items.append((tag, "intvec", np.asarray(v, np.int32)))

    def set_intpairvec(self, tag: str, flat: np.ndarray) -> None:
        a = np.asarray(flat, np.int32)
        assert a.size % 2 == 0, "pair vector needs an even flat length"
        self.items.append((tag, "intpairvec", a))

    def set_double(self, tag: str, v: float) -> None:
        self.items.append((tag, "double", float(v)))

    def set_flag(self, tag: str) -> None:
        self.items.append((tag, "flag", None))

    # untagged values: Kaldi writes some tags with TWO payloads
    # (<AlphaInOut> f f, <RankInOut> i i); the second rides tag None
    def append_untagged_float(self, v: float) -> None:
        self.items.append((None, "float", float(v)))

    def append_untagged_int(self, v: int) -> None:
        self.items.append((None, "int", int(v)))


@dataclass
class Nnet3Model:
    config_lines: List[str]
    components: List[BinaryComponent]
    transition_model: Optional[bytes] = None   # opaque, round-trips

    def component(self, name: str) -> BinaryComponent:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(name)


# ---------------------------------------------------------------------------
# primitives on top of BinaryReader
# ---------------------------------------------------------------------------

def _skip_ws(r: BinaryReader) -> None:
    while True:
        b = r.peek_byte()
        if b is None or b not in (0x20, 0x0A, 0x0D, 0x09):
            return
        r.read_byte()


def _read_token(r: BinaryReader) -> str:
    _skip_ws(r)
    return r.read_token()


def _peek_marker(r: BinaryReader, n: int = 3) -> bytes:
    """Peek up to n bytes without consuming."""
    out = []
    got = []
    for _ in range(n):
        b = r.try_read_byte()
        if b is None:
            break
        got.append(b)
    for b in reversed(got):
        r.unread_byte(b)
    return bytes(got)


def _read_vector(r: BinaryReader, double: bool) -> np.ndarray:
    n = r.read_basic_int()
    raw = r.read_bytes(n * (8 if double else 4))
    a = np.frombuffer(raw, dtype=np.float64 if double else np.float32)
    return a.astype(np.float32)


def _read_matrix(r: BinaryReader, double: bool) -> np.ndarray:
    rows = r.read_basic_int()
    cols = r.read_basic_int()
    raw = r.read_bytes(rows * cols * (8 if double else 4))
    a = np.frombuffer(raw, dtype=np.float64 if double else np.float32)
    return a.astype(np.float32).reshape(rows, cols)


def _plausible_float(raw4: bytes) -> bool:
    f = struct.unpack("<f", raw4)[0]
    if f == 0.0:
        return True
    a = abs(f)
    return np.isfinite(f) and 1e-20 < a < 1e20


# ---------------------------------------------------------------------------
# component reader (generic, tag-driven)
# ---------------------------------------------------------------------------

def _looks_like_tag(b: bytes) -> bool:
    """Do these peeked bytes begin a Kaldi ASCII token like '<Tag>' or
    '</Tag>'?  Used only by the <Offsets> legacy-framing sniff."""
    if not b.startswith(b"<"):
        return False
    end = b.find(b">")
    if end <= 1:
        return False
    body = b[1:end]
    return all(c == ord("/") or c == ord("-") or c == ord("_")
               or c == ord(".") or 48 <= c <= 57
               or 65 <= c <= 90 or 97 <= c <= 122 for c in body)


def _read_intvec(r: BinaryReader) -> np.ndarray:
    """Kaldi ReadIntegerVector: sized int32 count, then the RAW int32
    array (one block, no per-element size bytes)."""
    n = r.read_basic_int()
    if n < 0 or n > 100_000_000:
        raise ValueError(f"implausible integer-vector length {n}")
    raw = r.read_bytes(n * 4)
    return np.frombuffer(raw, dtype=np.int32).copy()


def read_component(r: BinaryReader) -> BinaryComponent:
    """Reads `<ClassName> ...tags/data... </ClassName>` generically,
    recording payload items in source order."""
    cls = _read_token(r)
    if not (cls.startswith("<") and cls.endswith(">")):
        raise ValueError(f"expected component class token, got {cls!r}")
    comp = BinaryComponent(type=cls[1:-1])
    end = f"</{cls[1:-1]}>"
    pending: Optional[str] = None     # last tag awaiting a value
    while True:
        _skip_ws(r)
        mk = _peek_marker(r, 3)
        if not mk:
            raise ValueError(f"EOF inside component {comp.type}")
        if mk[:1] == b"<":
            tok = _read_token(r)
            if tok == end:
                if pending is not None:
                    comp.items.append((pending, "flag", None))
                return comp
            if pending is not None:
                comp.items.append((pending, "flag", None))
            pending = tok
            continue
        # value for the pending tag
        if mk[:3] in (b"FV ", b"FM ", b"DV ", b"DM "):
            tok = _read_token(r)
            double = tok[0] == "D"
            if tok[1] == "V":
                comp.items.append(
                    (pending, "vector", _read_vector(r, double)))
            else:
                comp.items.append(
                    (pending, "matrix", _read_matrix(r, double)))
            pending = None
            continue
        if mk[:1] in (b"T", b"F") and pending in _BOOL_TAGS:
            comp.items.append((pending, "bool", r.read_byte() == ord("T")))
            pending = None
            continue
        if mk[:1] == b"\x04":
            if pending in _INTVEC_TAGS:
                comp.items.append((pending, "intvec", _read_intvec(r)))
                pending = None
                continue
            if pending in _INTPAIRVEC_TAGS:
                n = r.read_basic_int()
                if n < 0 or n > 50_000_000:
                    raise ValueError(
                        f"implausible integer-pair-vector length {n}")
                raw = r.read_bytes(n * 4)
                # Legacy sniff: pre-pair-vector exporters of this repo
                # framed <Offsets> as WriteIntegerVector (count = number
                # of INTS, so the payload is complete after 4n bytes and
                # the next bytes start the following '<Tag>').  Kaldi's
                # WriteIntegerPairVector (count = number of PAIRS,
                # convolution.cc) has 4n data bytes still to come, which
                # cannot begin a plausible ASCII tag — offset ints would
                # need to spell '<Xyz...>' byte-for-byte.
                if n % 2 == 0 and _looks_like_tag(_peek_marker(r, 34)):
                    flat = np.frombuffer(raw, dtype=np.int32).copy()
                else:
                    flat = np.frombuffer(raw + r.read_bytes(n * 4),
                                         dtype=np.int32).copy()
                comp.items.append((pending, "intpairvec", flat))
                pending = None
                continue
            r.read_byte()
            raw4 = r.read_bytes(4)
            iv = struct.unpack("<i", raw4)[0]
            if pending in _INT_TAGS:
                comp.items.append((pending, "int", iv))
            elif (not _plausible_float(raw4)
                  and -100_000_000 < iv < 100_000_000):
                # unknown tag whose bits are not a sane float but ARE a
                # sane int (counts/dims): int is the safer interpretation;
                # an implausible int too (e.g. a denormal-range float like
                # a 1e-25 probability floor) stays a float
                comp.items.append((pending, "int", iv))
            else:
                comp.items.append(
                    (pending, "float", struct.unpack("<f", raw4)[0]))
            pending = None
            continue
        if mk[:1] == b"\x08":
            r.read_byte()
            comp.items.append(
                (pending, "double",
                 struct.unpack("<d", r.read_bytes(8))[0]))
            pending = None
            continue
        if mk[:1] in (b"T", b"F"):
            comp.items.append((pending, "bool", r.read_byte() == ord("T")))
            pending = None
            continue
        raise ValueError(
            f"unrecognized payload {mk!r} after tag {pending!r} "
            f"in {comp.type}")


def _write_item(w: BinaryWriter, tag: Optional[str], kind: str,
                v: object) -> None:
    if tag is not None:
        w.write_token(tag)
    if kind == "flag":
        return
    if kind == "int":
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", int(v)))
    elif kind == "float":
        w.write_byte(4)
        w.write_bytes(struct.pack("<f", float(v)))
    elif kind == "double":
        w.write_byte(8)
        w.write_bytes(struct.pack("<d", float(v)))
    elif kind == "bool":
        w.write_bytes(b"T" if v else b"F")
    elif kind == "intvec":
        a = np.ascontiguousarray(v, np.int32)
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", len(a)))
        w.write_bytes(a.tobytes())
    elif kind == "intpairvec":
        # Kaldi WriteIntegerPairVector: count = #pairs, then 2*count raw
        # int32s (io-funcs-inl.h)
        a = np.ascontiguousarray(v, np.int32)
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", len(a) // 2))
        w.write_bytes(a.tobytes())
    elif kind == "vector":
        a = np.ascontiguousarray(v, np.float32)
        w.write_token("FV")
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", len(a)))
        w.write_bytes(a.tobytes())
    elif kind == "matrix":
        a = np.ascontiguousarray(v, np.float32)
        w.write_token("FM")
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", a.shape[0]))
        w.write_byte(4)
        w.write_bytes(struct.pack("<i", a.shape[1]))
        w.write_bytes(a.tobytes())
    else:
        raise ValueError(f"unknown item kind {kind!r}")


def write_component(w: BinaryWriter, comp: BinaryComponent) -> None:
    """Inverse of read_component: replays `items` in their original
    order, so read->write of a foreign component is order- and
    content-preserving (Kaldi readers are ExpectToken-sequenced)."""
    w.write_token(f"<{comp.type}>")
    for tag, kind, v in comp.items:
        _write_item(w, tag, kind, v)
    w.write_token(f"</{comp.type}>")


# ---------------------------------------------------------------------------
# whole-file read/write
# ---------------------------------------------------------------------------

def _scan_past(r: BinaryReader, needle: bytes) -> bytes:
    """Consume bytes up to and including `needle`, returning them.  Used to
    keep the TransitionModel opaque: the end token's 18 ASCII bytes
    appearing inside float payloads is astronomically unlikely."""
    out = bytearray()
    window = bytearray()
    while True:
        b = r.read_byte()
        out.append(b)
        window.append(b)
        if len(window) > len(needle):
            del window[0]
        if bytes(window) == needle:
            return bytes(out)


def read_nnet3(path_or_bytes) -> Nnet3Model:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        r = BinaryReader(bytes(path_or_bytes))
    else:
        r = BinaryReader.open(path_or_bytes)
    first2 = r.read_bytes(2)
    if first2 != b"\x00B":
        raise ValueError("not a Kaldi binary file (missing \\0B header); "
                         "use models/kaldi_loader.py for text models")
    tm: Optional[bytes] = None
    _skip_ws(r)
    mk = _peek_marker(r, len("<TransitionModel>"))
    if mk.startswith(b"<TransitionModel>"):
        tm = _scan_past(r, b"</TransitionModel>")
        # trailing space after the close token
        if r.peek_byte() == 0x20:
            r.read_byte()
            tm += b" "
    tok = _read_token(r)
    if tok != "<Nnet3>":
        raise ValueError(f"expected <Nnet3>, got {tok!r}")
    # config lines: text until a blank line
    config_lines: List[str] = []
    line = bytearray()
    # consume exactly the ONE newline right after "<Nnet3> " — a second
    # newline is the blank line that ends an empty config section
    if r.peek_byte() == 0x0D:
        r.read_byte()
    if r.peek_byte() == 0x0A:
        r.read_byte()
    while True:
        b = r.read_byte()
        if b == 0x0A:
            s = line.decode("utf-8").strip()
            line.clear()
            if not s:
                break
            config_lines.append(s)
        else:
            line.append(b)
    r.expect_token("<NumComponents>")
    n = r.read_basic_int()
    comps: List[BinaryComponent] = []
    for _ in range(n):
        _skip_ws(r)
        tok = _read_token(r)
        if tok != "<ComponentName>":
            raise ValueError(f"expected <ComponentName>, got {tok!r}")
        name = _read_token(r)
        comp = read_component(r)
        comp.name = name
        comps.append(comp)
    tok = _read_token(r)
    if tok != "</Nnet3>":
        raise ValueError(f"expected </Nnet3>, got {tok!r}")
    return Nnet3Model(config_lines=config_lines, components=comps,
                      transition_model=tm)


def write_nnet3(model: Nnet3Model, path: Optional[str] = None) -> bytes:
    w = BinaryWriter()
    w.write_bytes(b"\x00B")
    if model.transition_model is not None:
        w.write_bytes(model.transition_model)
    w.write_token("<Nnet3>")
    w.write_bytes(b"\n")
    for line in model.config_lines:
        w.write_bytes(line.encode("utf-8") + b"\n")
    w.write_bytes(b"\n")
    w.write_token("<NumComponents>")
    w.write_basic_int(len(model.components), with_space=False)
    for comp in model.components:
        w.write_token("<ComponentName>")
        w.write_token(comp.name)
        write_component(w, comp)
    w.write_token("</Nnet3>")
    data = w.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


# ---------------------------------------------------------------------------
# bridge to the text-loader component model
# ---------------------------------------------------------------------------

def to_kaldi_components(model: Nnet3Model):
    """Convert parsed binary components into the KaldiComponent dict the
    text loader's `load_params_from_components` consumes."""
    from kaldi_fp16_tpu_torch.models.kaldi_loader import (
        KaldiComponent, _FLOAT_TAGS, _INT_TAGS as _TXT_INT_TAGS,
        _MATRIX_TAGS,
    )
    out: Dict[str, KaldiComponent] = {}
    for c in model.components:
        kc = KaldiComponent(name=c.name, type=c.type)
        for tag, attr in _FLOAT_TAGS.items():
            if tag in c.scalars:
                setattr(kc, attr, float(c.scalars[tag]))
        for tag, attr in _TXT_INT_TAGS.items():
            if tag in c.ints:
                setattr(kc, attr, int(c.ints[tag]))
        for tag, attr in _MATRIX_TAGS.items():
            if tag in c.matrices:
                setattr(kc, attr, c.matrices[tag])
            elif tag in c.vectors:
                setattr(kc, attr, c.vectors[tag])
        # bias/stats are vectors in Kaldi; matrices dict holds 2-d only
        ivs = c.int_vectors
        if "<Offsets>" in ivs:
            flat = ivs["<Offsets>"].tolist()
            kc.offsets = list(zip(flat[0::2], flat[1::2]))
        if "<TimeOffsets>" in ivs:
            kc.time_offsets = ivs["<TimeOffsets>"].tolist()
        out[c.name] = kc
    return out


def components_from_text(components: Dict) -> List[BinaryComponent]:
    """Inverse bridge: text-parsed KaldiComponents -> binary components.

    Tags are emitted in Kaldi's canonical per-component Write() order for
    the component families this framework models — affine/linear
    (WriteUpdatableCommon prologue, then params, then natural-gradient
    config with Kaldi defaults filled in) and BatchNormComponent (Dim /
    BlockDim / Epsilon / TargetRms / TestMode / Count / stats, with
    required tags present even when zero) — so real Kaldi's
    ExpectToken-sequenced readers can consume the output, not just this
    repo's tag-driven reader (ref: Kaldi nnet-simple-component.cc
    Write() sequences).  Unknown component types fall back to a stable
    attribute order readable by this framework only."""
    from kaldi_fp16_tpu_torch.models.kaldi_loader import (
        _FLOAT_TAGS, _INT_TAGS as _TXT_INT_TAGS,
    )

    _AFFINE_TYPES = {
        "NaturalGradientAffineComponent", "AffineComponent",
        "FixedAffineComponent",
    }
    _LINEAR_TYPES = {"LinearComponent", "NaturalGradientLinearComponent"}

    def updatable_prologue(bc, kc):
        # WriteUpdatableCommon: optional <MaxChange> / <L2Regularize>
        # (written only when nonzero, as Kaldi does), then <LearningRate>
        # which is ALWAYS present — including 0.0.
        if getattr(kc, "max_change", 0.0):
            bc.set_float("<MaxChange>", kc.max_change)
        if getattr(kc, "l2_regularize", 0.0):
            bc.set_float("<L2Regularize>", kc.l2_regularize)
        bc.set_float("<LearningRate>", getattr(kc, "learning_rate", 0.0))

    out: List[BinaryComponent] = []
    for name, kc in components.items():
        bc = BinaryComponent(name=name, type=kc.type)
        if kc.type in _AFFINE_TYPES and kc.linear_params is not None:
            if kc.type != "FixedAffineComponent":
                updatable_prologue(bc, kc)
            bc.set_matrix("<LinearParams>", kc.linear_params)
            bc.set_vector("<BiasParams>",
                          kc.bias_params if kc.bias_params is not None
                          else np.zeros(kc.linear_params.shape[0],
                                        np.float32))
            if kc.type == "NaturalGradientAffineComponent":
                # NG config, Kaldi defaults (required by Kaldi's Read)
                bc.set_int("<RankIn>", 20)
                bc.set_int("<RankOut>", 80)
                bc.set_int("<UpdatePeriod>", 4)
                bc.set_float("<NumSamplesHistory>", 2000.0)
                bc.set_float("<Alpha>", 4.0)
        elif kc.type in _LINEAR_TYPES and kc.linear_params is not None:
            updatable_prologue(bc, kc)
            bc.set_matrix("<Params>", kc.linear_params)
            bc.set_float("<OrthonormalConstraint>", 0.0)
            bc.set_bool("<UseNaturalGradient>", True)
        elif kc.type == "BatchNormComponent" and kc.stats_mean is not None:
            dim = len(kc.stats_mean)
            bc.set_int("<Dim>", dim)
            bc.set_int("<BlockDim>", dim)
            bc.set_float("<Epsilon>", kc.epsilon or 1.0e-3)
            bc.set_float("<TargetRms>", kc.target_rms or 1.0)
            bc.set_bool("<TestMode>", False)
            # count_ is a double in Kaldi (nnet-normalize-component.h),
            # written as an 8-byte WriteBasicType<double>
            bc.set_double("<Count>", kc.count)
            bc.set_vector("<StatsMean>", kc.stats_mean)
            if kc.stats_var is not None:
                bc.set_vector("<StatsVar>", kc.stats_var)
        elif (kc.type == "TimeHeightConvolutionComponent"
              and kc.linear_params is not None):
            # Kaldi's Write() (nnet-convolutional-component.cc):
            # WriteUpdatableCommon, then ConvolutionModel::Write
            # (convolution.cc: <ConvolutionModel> <NumFiltersIn>
            # <NumFiltersOut> <HeightIn> <HeightOut> <HeightSubsampleOut>
            # <Offsets> [pair vector] <RequiredTimeOffsets> [int vector]
            # </ConvolutionModel>), then <LinearParams> <BiasParams>
            # <MaxMemoryMb> and the natural-gradient tail
            # <UseNaturalGradient> <NumMinibatchesHistory> <AlphaInOut>
            # (two floats) <RankInOut> (two ints) — ExpectToken-required
            # by Kaldi's Read.  The <Model> token before the block is
            # pinned by the captured text fixture
            # (tests/test_kaldi_loader.py FIXTURE cnn1.conv line, a
            # mirror of real nnet3-copy output).  The offset lists come
            # from the text
            # bridge's "<Offsets> [ t,h ... ]" (export_weights_text emits
            # them; weight_loader.go:617-728 never parses them, so a model
            # imported THROUGH the reference's text dialect has none —
            # then the ConvolutionModel block is omitted and the
            # component is PARTIAL, readable by this repo only).
            updatable_prologue(bc, kc)
            if kc.offsets:
                bc.set_flag("<Model>")
                bc.set_flag("<ConvolutionModel>")
                bc.set_int("<NumFiltersIn>", kc.num_filters_in)
                bc.set_int("<NumFiltersOut>", kc.num_filters_out)
                bc.set_int("<HeightIn>", kc.height_in)
                bc.set_int("<HeightOut>", kc.height_out)
                bc.set_int("<HeightSubsampleOut>", kc.height_subsample or 1)
                bc.set_intpairvec(
                    "<Offsets>",
                    np.asarray([v for th in kc.offsets for v in th],
                               np.int32))
                bc.set_intvec("<RequiredTimeOffsets>",
                              np.asarray(sorted({t for t, _ in kc.offsets}),
                                         np.int32))
                bc.set_flag("</ConvolutionModel>")
            else:
                bc.set_int("<NumFiltersIn>", kc.num_filters_in)
                bc.set_int("<NumFiltersOut>", kc.num_filters_out)
                bc.set_int("<HeightIn>", kc.height_in)
                bc.set_int("<HeightOut>", kc.height_out)
            bc.set_matrix("<LinearParams>", kc.linear_params)
            bc.set_vector("<BiasParams>",
                          kc.bias_params if kc.bias_params is not None
                          else np.zeros(kc.linear_params.shape[0],
                                        np.float32))
            if kc.offsets:
                bc.set_float("<MaxMemoryMb>", 200.0)
                bc.set_bool("<UseNaturalGradient>", True)
                bc.set_float("<NumMinibatchesHistory>", 4.0)
                bc.set_float("<AlphaInOut>", 4.0)
                bc.append_untagged_float(4.0)
                bc.set_int("<RankInOut>", 20)
                bc.append_untagged_int(80)
        elif kc.type == "TdnnComponent" and kc.linear_params is not None:
            # Kaldi's Write() (nnet-tdnn-component.cc):
            # WriteUpdatableCommon, <TimeOffsets>, <LinearParams>,
            # <BiasParams> (present only when the component has a bias),
            # <OrthonormalConstraint>, <UseNaturalGradient>, then the
            # natural-gradient tail <NumSamplesHistory> <AlphaInOut>
            # (two floats) <RankInOut> (two ints) — ExpectToken-required
            # by Kaldi's Read.  <TimeOffsets> comes from the text
            # bridge's "<TimeOffsets> [ t ... ]" (export_weights_text
            # emits it; the reference's text dialect has none — then the
            # tag is omitted and the component is PARTIAL, as before).
            updatable_prologue(bc, kc)
            if kc.time_offsets:
                bc.set_intvec("<TimeOffsets>",
                              np.asarray(kc.time_offsets, np.int32))
            bc.set_matrix("<LinearParams>", kc.linear_params)
            if kc.bias_params is not None:
                bc.set_vector("<BiasParams>", kc.bias_params)
            bc.set_float("<OrthonormalConstraint>", 0.0)
            bc.set_bool("<UseNaturalGradient>", True)
            if kc.time_offsets:
                bc.set_float("<NumSamplesHistory>", 2000.0)
                bc.set_float("<AlphaInOut>", 4.0)
                bc.append_untagged_float(4.0)
                bc.set_int("<RankInOut>", 20)
                bc.append_untagged_int(80)
        elif kc.type == "RestrictedAttentionComponent":
            # Kaldi's Write(): <NumHeads> <KeyDim> <ValueDim> ...context
            # ints... <KeyScale> <StatsCount> (ref: Kaldi
            # nnet-attention-component.cc); the fields the text bridge
            # knows are emitted in that relative order, zero or not.
            bc.set_int("<NumHeads>", kc.num_heads)
            bc.set_int("<KeyDim>", kc.key_dim)
            bc.set_int("<ValueDim>", kc.value_dim)
            bc.set_float("<KeyScale>", kc.key_scale)
            bc.set_float("<Count>", kc.count)
        else:
            # genuinely unknown type: DECLARED tag-map order (stable,
            # not alphabetical), zero-valued required scalars kept;
            # readable by this repo's tag-driven reader
            for tag, attr in _TXT_INT_TAGS.items():
                v = getattr(kc, attr)
                if v:
                    bc.set_int(tag, v)
            for tag, attr in _FLOAT_TAGS.items():
                v = getattr(kc, attr)
                if v or attr in ("learning_rate", "count"):
                    bc.set_float(tag, v)
            if kc.linear_params is not None:
                bc.set_matrix("<LinearParams>", kc.linear_params)
            if kc.bias_params is not None:
                bc.set_vector("<BiasParams>", kc.bias_params)
            if kc.stats_mean is not None:
                bc.set_vector("<StatsMean>", kc.stats_mean)
            if kc.stats_var is not None:
                bc.set_vector("<StatsVar>", kc.stats_var)
        out.append(bc)
    return out
