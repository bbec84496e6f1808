"""Kaldi nnet3 model import/export (the `nnet3-copy --binary=false` text form).

Import mirrors the reference weight loader (ref:
internal/nnet/weight_loader.go:617-1137): scan `<ComponentName> name <Type>`
headers with inline scalar tags, accumulate `<LinearParams>/<Params>/
<BiasParams>/<StatsMean>/<StatsVar>` matrices across lines, then map
components onto layers by naming convention — cnnN.conv/.batchnorm,
tdnnfN.linear/.affine/.batchnorm, prefinal-X.affine/.linear/.batchnorm1/2,
output.affine, idct — with a TRANSPOSE (Kaldi stores [out, in], we compute
x @ W with W [in, out]; ref weight_loader.go:958-990) and per-filter
BatchNorm block stats tiled across heights (ref: makeBlockBN,
weight_loader.go:554-598 — tiled for OUR h*nf+f layout, i.e.
full[h*nf + f] = block[f]).

The exporter emits the same text format so import/export round-trips and
models can be handed back to Kaldi tooling.

Port of kaldi_fp16_tpu/models/kaldi_loader.py.  The parser, the mapping
(`load_params_from_components`, `load_weights_from_text`,
`load_weights_from_file`) and the exporter (`export_params_to_text`) are
copies that work on (params, state) trees of numpy arrays in the JAX
package's layout, so they give the JAX loader's trees and text exactly
(tests/test_torch_kaldi_loader.py).  A `Network` goes through them by way
of convert.py: `load_into_network` and `export_network_text`;
`text_to_binary` writes exported text as a binary .raw.  As in the JAX
package, an attention layer is neither loaded nor exported (ROADMAP
queue 3).
"""

from __future__ import annotations

import re
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.xconfig import LayerType
from kaldi_fp16_tpu_torch.models.layers import (
    BatchnormSpec, ConvReluBNSpec, PrefinalSpec, TDNNFSpec,
)


@dataclass
class KaldiComponent:
    name: str = ""
    type: str = ""
    linear_params: Optional[np.ndarray] = None   # [rows, cols] as printed
    bias_params: Optional[np.ndarray] = None
    stats_mean: Optional[np.ndarray] = None
    stats_var: Optional[np.ndarray] = None
    epsilon: float = 0.0
    target_rms: float = 0.0
    count: float = 0.0
    learning_rate: float = 0.0
    max_change: float = 0.0
    l2_regularize: float = 0.0
    num_filters_in: int = 0
    num_filters_out: int = 0
    height_in: int = 0
    height_out: int = 0
    num_heads: int = 0
    key_dim: int = 0
    value_dim: int = 0
    key_scale: float = 0.0
    height_subsample: int = 0
    # conv (time,height) offset pairs / tdnn time offsets, as written by
    # export_weights_text ("<Offsets> [ t,h ... ]" / "<TimeOffsets> [ t ... ]");
    # carried so the binary bridge can emit real Kaldi's offset lists
    offsets: Optional[List[Tuple[int, int]]] = None
    time_offsets: Optional[List[int]] = None


_FLOAT_TAGS = {
    "<LearningRate>": "learning_rate", "<MaxChange>": "max_change",
    "<L2Regularize>": "l2_regularize", "<Epsilon>": "epsilon",
    "<TargetRms>": "target_rms", "<Count>": "count", "<KeyScale>": "key_scale",
}
_INT_TAGS = {
    "<NumFiltersIn>": "num_filters_in", "<NumFiltersOut>": "num_filters_out",
    "<HeightIn>": "height_in", "<HeightOut>": "height_out",
    "<HeightSubsampleOut>": "height_subsample",
    "<NumHeads>": "num_heads", "<KeyDim>": "key_dim", "<ValueDim>": "value_dim",
}
_MATRIX_TAGS = {
    "<LinearParams>": "linear_params", "<Params>": "linear_params",
    "<BiasParams>": "bias_params", "<StatsMean>": "stats_mean",
    "<StatsVar>": "stats_var",
}


def _tag_value(line: str, tag: str) -> Optional[str]:
    idx = line.find(tag)
    if idx < 0:
        return None
    rest = line[idx + len(tag):].strip().split()
    return rest[0] if rest else None


def _parse_floats(s: str) -> List[float]:
    out = []
    for tok in s.split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return out


def parse_nnet3_text(text: str) -> Dict[str, KaldiComponent]:
    components: Dict[str, KaldiComponent] = {}
    current: Optional[KaldiComponent] = None
    matrix_rows: List[List[float]] = []
    matrix_attr = ""
    in_matrix = False

    def finish_matrix():
        nonlocal in_matrix, matrix_rows, matrix_attr
        if current is not None and matrix_rows:
            flat = [r for r in matrix_rows if r]
            if flat:
                if matrix_attr in ("bias_params", "stats_mean", "stats_var"):
                    arr = np.asarray([v for r in flat for v in r], np.float32)
                else:
                    arr = np.asarray(flat, dtype=np.float32)
                setattr(current, matrix_attr, arr)
        in_matrix = False
        matrix_rows = []
        matrix_attr = ""

    for line in text.splitlines():
        if "<ComponentName>" in line:
            if in_matrix:
                finish_matrix()
            if current is not None:
                components[current.name] = current
            current = KaldiComponent()
            parts = line[line.index("<ComponentName>") + len("<ComponentName>"):].split()
            if len(parts) >= 2:
                current.name = parts[0]
                current.type = parts[1].strip("<>")
        if current is None:
            continue

        for tag, attr in _FLOAT_TAGS.items():
            v = _tag_value(line, tag)
            if v is not None and getattr(current, attr) == 0.0:
                try:
                    setattr(current, attr, float(v))
                except ValueError:
                    pass
        for tag, attr in _INT_TAGS.items():
            v = _tag_value(line, tag)
            if v is not None and getattr(current, attr) == 0:
                try:
                    setattr(current, attr, int(v))
                except ValueError:
                    pass

        # bracketed offset lists: "<Offsets> [ t,h t,h ... ]" (conv) and
        # "<TimeOffsets> [ t t ... ]" (tdnn) — always single-line in the
        # text format (export_weights_text writes them inline)
        for tag, attr, pairs in (("<Offsets>", "offsets", True),
                                 ("<TimeOffsets>", "time_offsets", False)):
            idx = line.find(tag)
            if idx < 0 or getattr(current, attr) is not None:
                continue
            bracket = line.find("[", idx)
            if bracket < 0:
                continue
            inner = line[bracket + 1:]
            if "]" in inner:
                inner = inner[:inner.index("]")]
            try:
                if pairs:
                    setattr(current, attr,
                            [tuple(int(x) for x in tok.split(","))
                             for tok in inner.split()])
                else:
                    setattr(current, attr,
                            [int(tok) for tok in inner.split()])
            except ValueError:
                pass

        started = False
        for tag, attr in _MATRIX_TAGS.items():
            idx = line.find(tag)
            if idx < 0:
                continue
            if in_matrix:
                finish_matrix()
            matrix_attr = attr
            in_matrix = True
            started = True
            bracket = line.find("[", idx)
            if bracket >= 0:
                after = line[bracket + 1:]
                if "]" in after:
                    inner = after[:after.index("]")]
                    matrix_rows.append(_parse_floats(inner))
                    finish_matrix()
                else:
                    vals = _parse_floats(after)
                    if vals:
                        matrix_rows.append(vals)
            break

        if in_matrix and not started and "<" not in line:
            s = line.strip()
            if not s:
                continue
            close = "]" in s
            vals = _parse_floats(s.replace("]", " "))
            if vals:
                matrix_rows.append(vals)
            if close:
                finish_matrix()

    if in_matrix:
        finish_matrix()
    if current is not None:
        components[current.name] = current
    return components


def export_model_text(model_path: str, nnet3_copy: str = "nnet3-copy") -> str:
    """Run `nnet3-copy --binary=false model -` (requires Kaldi installed;
    ref: weight_loader.go:605-613)."""
    out = subprocess.run([nnet3_copy, "--binary=false", model_path, "-"],
                         capture_output=True, check=True)
    return out.stdout.decode()


# ---------------------------------------------------------------------------
# Mapping components -> params/state
# ---------------------------------------------------------------------------

def _bn_state_from(comp: KaldiComponent, dim: int) -> Dict[str, np.ndarray]:
    mean = comp.stats_mean
    var = comp.stats_var
    if mean is None:
        raise ValueError(f"{comp.name}: missing StatsMean")
    if var is None:
        var = np.ones_like(mean)
    block = len(mean)
    if block != dim:
        if dim % block != 0:
            raise ValueError(f"{comp.name}: BlockDim {block} does not divide {dim}")
        height = dim // block
        # our layout is h*nf + f: tile per-filter stats across heights
        mean = np.tile(mean, height)
        var = np.tile(var, height)
    return {"count": np.asarray(max(comp.count, 1.0), np.float32),
            "mean": np.asarray(mean, np.float32),
            "var": np.asarray(np.maximum(var, 0.0), np.float32)}


def _t(m: np.ndarray) -> np.ndarray:
    return np.asarray(np.ascontiguousarray(m.T), np.float32)


def load_params_from_components(model: Model, params: dict, state: dict,
                                components: Dict[str, KaldiComponent]
                                ) -> Tuple[dict, dict, Dict[str, int]]:
    """Replace init params/state with Kaldi weights.  Returns
    (params, state, report) where report counts loaded values per layer."""
    params = {k: dict(v) for k, v in params.items()}
    state = {k: (dict(v) if isinstance(v, dict) else v) for k, v in state.items()}
    report: Dict[str, int] = {}

    def need(name: str) -> KaldiComponent:
        c = components.get(name)
        if c is None:
            raise KeyError(f"component {name!r} not found in model text")
        return c

    for layer in model.layers:
        n = layer.name
        t = layer.type
        loaded = 0
        if t == LayerType.IDCT:
            c = components.get("idct") or components.get(n)
            if c is not None and c.linear_params is not None:
                params[n]["idct"] = _t(c.linear_params)
                loaded = c.linear_params.size
        elif t == LayerType.LINEAR:
            c = components.get(n)
            if c is not None and c.linear_params is not None:
                params[n]["w"] = _t(c.linear_params)
                loaded = c.linear_params.size
        elif t == LayerType.BATCHNORM:
            c = components.get(n)
            if c is not None and c.stats_mean is not None:
                state[n] = _bn_state_from(c, layer.output_dim)
                loaded = len(c.stats_mean) * 2
        elif t == LayerType.CONV_RELU_BATCHNORM:
            c = need(f"{n}.conv")
            spec: ConvReluBNSpec = layer.spec
            k = len(spec.offsets) * spec.num_filters_in
            if c.linear_params.shape != (spec.num_filters_out, k):
                raise ValueError(
                    f"{n}.conv: params {c.linear_params.shape} != "
                    f"({spec.num_filters_out}, {k})")
            params[n]["w"] = _t(c.linear_params)
            if c.bias_params is not None:
                params[n]["b"] = np.asarray(c.bias_params, np.float32)
            bn = components.get(f"{n}.batchnorm")
            if bn is not None and bn.stats_mean is not None:
                state[n] = _bn_state_from(bn, layer.output_dim)
            loaded = c.linear_params.size
        elif t == LayerType.TDNNF:
            lin = need(f"{n}.linear")
            aff = need(f"{n}.affine")
            params[n]["linear_w"] = _t(lin.linear_params)
            params[n]["affine_w"] = _t(aff.linear_params)
            if aff.bias_params is not None:
                params[n]["affine_b"] = np.asarray(aff.bias_params, np.float32)
            bn = components.get(f"{n}.batchnorm")
            if bn is not None and bn.stats_mean is not None:
                state[n] = _bn_state_from(bn, layer.output_dim)
            loaded = lin.linear_params.size + aff.linear_params.size
        elif t == LayerType.RELU_BATCHNORM:
            c = need(f"{n}.affine")
            params[n]["w"] = _t(c.linear_params)
            if c.bias_params is not None:
                params[n]["b"] = np.asarray(c.bias_params, np.float32)
            bn = components.get(f"{n}.batchnorm")
            if bn is not None and bn.stats_mean is not None:
                state[n] = _bn_state_from(bn, layer.output_dim)
            loaded = c.linear_params.size
        elif t == LayerType.PREFINAL:
            spec: PrefinalSpec = layer.spec
            aff = need(f"{n}.affine")
            params[n]["big_w"] = _t(aff.linear_params)
            if aff.bias_params is not None:
                params[n]["big_b"] = np.asarray(aff.bias_params, np.float32)
            lin = need(f"{n}.linear")
            params[n]["small_w"] = _t(lin.linear_params)
            bn1 = components.get(f"{n}.batchnorm1")
            bn2 = components.get(f"{n}.batchnorm2")
            if bn1 is not None and bn1.stats_mean is not None:
                state[n]["bn1"] = _bn_state_from(bn1, spec.big_dim)
            if bn2 is not None and bn2.stats_mean is not None:
                state[n]["bn2"] = _bn_state_from(bn2, spec.small_dim)
            loaded = aff.linear_params.size + lin.linear_params.size
        elif t == LayerType.OUTPUT:
            c = components.get(f"{n}.affine") or components.get(n)
            if c is not None and c.linear_params is not None:
                params[n]["w"] = _t(c.linear_params)
                if c.bias_params is not None:
                    params[n]["b"] = np.asarray(c.bias_params, np.float32)
                loaded = c.linear_params.size
        if loaded:
            report[n] = loaded
    return params, state, report


def load_weights_from_text(model: Model, params: dict, state: dict,
                           text: str):
    return load_params_from_components(model, params, state,
                                       parse_nnet3_text(text))


def load_weights_from_file(model: Model, params: dict, state: dict,
                           path: str):
    """Load a Kaldi model file, binary (.mdl/.raw, read standalone by
    io/nnet3_binary.py — no Kaldi install needed, unlike the reference's
    nnet3-copy subprocess) or `nnet3-copy --binary=false` text."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"\x00B":
        from kaldi_fp16_tpu_torch.io.nnet3_binary import (
            read_nnet3, to_kaldi_components,
        )
        comps = to_kaldi_components(read_nnet3(path))
        return load_params_from_components(model, params, state, comps)
    with open(path, "r") as f:
        return load_weights_from_text(model, params, state, f.read())


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _fmt_values(a: np.ndarray) -> str:
    """'%.9g' of each value, space-separated: the JAX exporter's
    f"{v:.9g}" strings (a float32 formats as its exact float), built by
    one %-format over Python floats rather than an f-string per value
    (the flagship's text holds 13.4 M values)."""
    vals = a.tolist()
    return " ".join(["%.9g"] * len(vals)) % tuple(vals)


def _fmt_matrix(m: np.ndarray) -> str:
    rows = [_fmt_values(row) for row in np.atleast_2d(m)]
    return " [\n  " + "\n  ".join(rows) + " ]"


def _fmt_vector(v: np.ndarray) -> str:
    return " [ " + _fmt_values(np.asarray(v).ravel()) + " ]"


def export_params_to_text(model: Model, params: dict, state: dict) -> str:
    """Emit nnet3 text components for our params (inverse transposes)."""
    lines: List[str] = []

    def bn_lines(name: str, st: dict, spec_dim: int, target_rms: float,
                 epsilon: float = 1e-3):
        lines.append(
            f"<ComponentName> {name} <BatchNormComponent> <Dim> {spec_dim} "
            f"<BlockDim> {spec_dim} <Epsilon> {epsilon:g} "
            f"<TargetRms> {target_rms:g} <TestMode> F "
            f"<Count> {float(st['count']):g} "
            f"<StatsMean> {_fmt_vector(np.asarray(st['mean']))}")
        lines.append(f"<StatsVar> {_fmt_vector(np.asarray(st['var']))}")

    for layer in model.layers:
        n = layer.name
        t = layer.type
        p = params.get(n, {})
        if t == LayerType.IDCT:
            lines.append(f"<ComponentName> {n} <FixedAffineComponent> "
                         f"<LinearParams>{_fmt_matrix(np.asarray(p['idct']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.zeros(layer.output_dim))}")
        elif t == LayerType.LINEAR:
            lines.append(f"<ComponentName> {n} <LinearComponent> "
                         f"<Params>{_fmt_matrix(np.asarray(p['w']).T)}")
        elif t == LayerType.BATCHNORM:
            bn_lines(n, state[n], layer.output_dim, layer.spec.target_rms,
                     layer.spec.epsilon)
        elif t == LayerType.CONV_RELU_BATCHNORM:
            spec = layer.spec
            offs = " ".join(f"{a},{b}" for a, b in spec.offsets)
            lines.append(
                f"<ComponentName> {n}.conv <TimeHeightConvolutionComponent> "
                f"<NumFiltersIn> {spec.num_filters_in} "
                f"<NumFiltersOut> {spec.num_filters_out} "
                f"<HeightIn> {spec.height_in} <HeightOut> {spec.height_out} "
                f"<HeightSubsampleOut> {spec.height_subsample} "
                f"<Offsets> [ {offs} ]")
            lines.append(f"<LinearParams>{_fmt_matrix(np.asarray(p['w']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.asarray(p['b']))}")
            bn_lines(f"{n}.batchnorm", state[n], layer.output_dim,
                     spec.target_rms)
        elif t == LayerType.TDNNF:
            spec = layer.spec
            s = spec.time_stride
            lines.append(f"<ComponentName> {n}.linear <TdnnComponent> "
                         f"<TimeOffsets> [ {-s} 0 ]" if s > 0 else
                         f"<ComponentName> {n}.linear <TdnnComponent> "
                         f"<TimeOffsets> [ 0 ]")
            lines.append(f"<LinearParams>{_fmt_matrix(np.asarray(p['linear_w']).T)}")
            lines.append(f"<BiasParams> [ ]")
            lines.append(f"<ComponentName> {n}.affine <TdnnComponent> "
                         f"<TimeOffsets> [ 0 {s} ]" if s > 0 else
                         f"<ComponentName> {n}.affine <TdnnComponent> "
                         f"<TimeOffsets> [ 0 ]")
            lines.append(f"<LinearParams>{_fmt_matrix(np.asarray(p['affine_w']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.asarray(p['affine_b']))}")
            bn_lines(f"{n}.batchnorm", state[n], layer.output_dim,
                     spec.target_rms)
        elif t == LayerType.RELU_BATCHNORM:
            lines.append(f"<ComponentName> {n}.affine "
                         f"<NaturalGradientAffineComponent> "
                         f"<LinearParams>{_fmt_matrix(np.asarray(p['w']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.asarray(p['b']))}")
            bn_lines(f"{n}.batchnorm", state[n], layer.output_dim,
                     layer.spec.target_rms)
        elif t == LayerType.PREFINAL:
            spec = layer.spec
            lines.append(f"<ComponentName> {n}.affine "
                         f"<NaturalGradientAffineComponent> "
                         f"<LinearParams>{_fmt_matrix(np.asarray(p['big_w']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.asarray(p['big_b']))}")
            bn_lines(f"{n}.batchnorm1", state[n]["bn1"], spec.big_dim,
                     spec.target_rms)
            lines.append(f"<ComponentName> {n}.linear <LinearComponent> "
                         f"<Params>{_fmt_matrix(np.asarray(p['small_w']).T)}")
            bn_lines(f"{n}.batchnorm2", state[n]["bn2"], spec.small_dim,
                     spec.target_rms)
        elif t == LayerType.OUTPUT:
            lines.append(f"<ComponentName> {n}.affine "
                         f"<NaturalGradientAffineComponent> "
                         f"<LinearParams>{_fmt_matrix(np.asarray(p['w']).T)}")
            lines.append(f"<BiasParams>{_fmt_vector(np.asarray(p['b']))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The port's Network
# ---------------------------------------------------------------------------

def load_into_network(net, path_or_text: str) -> Dict[str, int]:
    """Load a Kaldi model into `net` (a models.network.Network) in place:
    a model file (binary .mdl / .raw or nnet3 text) or nnet3 text itself.
    The weights go through `load_params_from_components` on the
    network's own trees (convert.params_to_numpy) and back into its
    parameters and BN buffers, which stay on their device.  Returns the
    report: values loaded per layer."""
    import os
    from kaldi_fp16_tpu_torch.convert import params_from_jax, params_to_numpy
    params, state = params_to_numpy(net)
    if os.path.isfile(path_or_text):
        params, state, report = load_weights_from_file(
            net.model, params, state, path_or_text)
    else:
        params, state, report = load_weights_from_text(
            net.model, params, state, path_or_text)
    net.load_state_dict(params_from_jax(net.model, params, state),
                        strict=True)
    return report


def export_network_text(net) -> str:
    """`net`'s weights as nnet3 text: `export_params_to_text` of its
    JAX-layout trees, the JAX exporter's text for the same weights."""
    from kaldi_fp16_tpu_torch.convert import params_to_numpy
    return export_params_to_text(net.model, *params_to_numpy(net))


def text_to_binary(text: str, path: Optional[str] = None) -> bytes:
    """nnet3 text -> a binary .raw container (no TransitionModel, no
    config lines), as tools/loadtest.py writes one; also to `path`."""
    from kaldi_fp16_tpu_torch.io.nnet3_binary import (
        Nnet3Model, components_from_text, write_nnet3,
    )
    return write_nnet3(Nnet3Model(
        config_lines=[],
        components=components_from_text(parse_nnet3_text(text))), path)
