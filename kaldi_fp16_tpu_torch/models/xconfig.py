"""Kaldi xconfig parser — the model-architecture DSL.

Parses lines of the form `layer-type key=value key=value ...` with a
paren-aware tokenizer so `input=Append(a, b)` survives as one token
(ref: internal/nnet/xconfig.go:242-271).  Supported layer types mirror the
reference (ref: xconfig.go:18-65); using real Kaldi recipe files is the
point of keeping this format.

Copy of kaldi_fp16_tpu/models/xconfig.py (pure Python).  The JAX
package's `models/__init__` imports jax, which the PyTorch port must not
need, so the port carries its own copy; tests/test_torch_network.py holds
the two equal on the layer types both have.  The port adds Kaldi's
TDNN-LSTM layer types (fixed-affine-layer, relu-renorm-layer,
fast-lstmp-layer) and, in an Append, time offsets of an input: an integer
k is the previous layer at t + k, and Offset(name, k) the named one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional


class LayerType(Enum):
    INPUT = "input"
    IDCT = "idct-layer"
    LINEAR = "linear-component"
    BATCHNORM = "batchnorm-component"
    SPEC_AUGMENT = "spec-augment-layer"
    COMBINE_FEATURE_MAPS = "combine-feature-maps-layer"
    CONV_RELU_BATCHNORM = "conv-relu-batchnorm-layer"
    TDNNF = "tdnnf-layer"
    ATTENTION_RELU_BATCHNORM = "attention-relu-batchnorm-layer"
    PREFINAL = "prefinal-layer"
    OUTPUT = "output-layer"
    RELU_BATCHNORM = "relu-batchnorm-layer"
    NO_OP = "no-op-component"
    # the TDNN-LSTM layers (the port's own; the JAX package has none)
    FIXED_AFFINE = "fixed-affine-layer"
    RELU_RENORM = "relu-renorm-layer"
    FAST_LSTMP = "fast-lstmp-layer"


_TYPE_BY_NAME = {t.value: t for t in LayerType}


@dataclass
class LayerConfig:
    type: LayerType
    name: str
    params: Dict[str, str] = field(default_factory=dict)
    line: int = 0

    # -- typed getters ------------------------------------------------------

    def get_str(self, key: str, default: str = "") -> str:
        return self.params.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.params.get(key)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.params.get(key)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.params.get(key)
        if v is None:
            return default
        return v.lower() in ("true", "1", "yes")

    def get_int_list(self, key: str) -> List[int]:
        v = self.params.get(key, "")
        if not v:
            return []
        return [int(x) for x in v.split(",") if x.strip()]

    def input_spec(self) -> str:
        return self.params.get("input", "")


def _tokenize(line: str) -> List[str]:
    """Split on whitespace but keep parenthesised groups intact."""
    tokens: List[str] = []
    cur: List[str] = []
    depth = 0
    for ch in line:
        if ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch in (" ", "\t"):
            if depth > 0:
                cur.append(ch)
            elif cur:
                tokens.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        tokens.append("".join(cur))
    return tokens


def parse_xconfig(text: str) -> List[LayerConfig]:
    configs: List[LayerConfig] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        tokens = _tokenize(line)
        type_name = tokens[0]
        ltype = _TYPE_BY_NAME.get(type_name)
        if ltype is None:
            raise ValueError(f"line {lineno}: unknown layer type {type_name!r}")
        params: Dict[str, str] = {}
        name = ""
        for tok in tokens[1:]:
            if "=" not in tok:
                raise ValueError(f"line {lineno}: bad token {tok!r}")
            key, val = tok.split("=", 1)
            if key == "name":
                name = val
            else:
                params[key] = val
        if not name:
            raise ValueError(f"line {lineno}: layer missing name")
        configs.append(LayerConfig(type=ltype, name=name, params=params,
                                   line=lineno))
    return configs


def parse_xconfig_file(path: str) -> List[LayerConfig]:
    with open(path) as f:
        return parse_xconfig(f.read())


# ---------------------------------------------------------------------------
# Input specification: Simple / Append(...) / ReplaceIndex(...) / previous
# ---------------------------------------------------------------------------

class InputType(Enum):
    PREVIOUS = 0   # implicit: use the previous layer
    SIMPLE = 1
    APPEND = 2
    REPLACE_INDEX = 3


@dataclass
class InputRef:
    type: InputType
    name: str = ""
    names: List[str] = field(default_factory=list)
    source: str = ""
    # an Append's time offset of each element (names[i] at t + offsets[i]);
    # an integer element is "" in names, the previous layer
    offsets: List[int] = field(default_factory=list)


def parse_input(spec: str) -> InputRef:
    spec = spec.strip()
    if not spec:
        return InputRef(InputType.PREVIOUS)
    if spec.startswith("Append(") and spec.endswith(")"):
        inner = spec[len("Append("):-1]
        names, offsets = [], []
        for p in _split_top_level(inner):
            name, off = _offset_element(_strip_inner(p))
            names.append(name)
            offsets.append(off)
        return InputRef(InputType.APPEND, names=names, offsets=offsets)
    if spec.startswith("ReplaceIndex(") and spec.endswith(")"):
        inner = spec[len("ReplaceIndex("):-1]
        parts = _split_top_level(inner)
        return InputRef(InputType.REPLACE_INDEX, source=parts[0].strip())
    return InputRef(InputType.SIMPLE, name=spec)


def _split_top_level(s: str) -> List[str]:
    out, cur, depth = [], [], 0
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _offset_element(s: str):
    """(name, time offset) of an Append element: an integer k is ("", k),
    the previous layer at t + k; Offset(name, k) is (name, k); anything
    else is itself at offset 0."""
    try:
        return "", int(s)
    except ValueError:
        pass
    if s.startswith("Offset(") and s.endswith(")"):
        parts = _split_top_level(s[len("Offset("):-1])
        if len(parts) == 2:
            return parts[0].strip(), int(parts[1])
    return s, 0


def _strip_inner(s: str) -> str:
    """An Append element may itself be ReplaceIndex(x, t, 0) — keep whole."""
    return s.strip()
