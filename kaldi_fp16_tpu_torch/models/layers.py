"""Layer resolution: xconfig configs -> typed specs with concrete dims.

Mirrors the reference's ResolveLayers (ref: internal/nnet/layers.go:120-374)
with one deliberate Kaldi-alignment fix: conv time-offsets x height-offsets
form a CARTESIAN product (Kaldi TimeHeightConvolutionComponent <Offsets>),
not zipped pairs as the reference assumed.  Feature-map layout everywhere is
Kaldi's: column = height_index * num_filters + filter_index (filter fastest).

Copy of kaldi_fp16_tpu/models/layers.py (pure Python, see xconfig.py),
with the port's own TDNN-LSTM layers: fixed-affine-layer, relu-renorm-layer,
fast-lstmp-layer and the output layer's output-delay (Kaldi's
steps/libs/nnet3/xconfig/{basic_layers,lstm}.py defaults).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kaldi_fp16_tpu_torch.models.xconfig import (
    InputRef, InputType, LayerConfig, LayerType, parse_input,
)


@dataclass
class InputSpec:
    ref: InputRef
    names: List[str] = field(default_factory=list)  # resolved source names
    dim: int = 0
    # each source's time offset (the source at t + offset); all 0 but in an
    # Append of offsets
    offsets: List[int] = field(default_factory=list)


# -- per-type specs ----------------------------------------------------------

@dataclass
class IDCTSpec:
    dim: int
    cepstral_lifter: float = 22.0
    affine_file: str = ""


@dataclass
class LinearSpec:
    input_dim: int
    output_dim: int
    l2_reg: float = 0.0
    orthonormal_constraint: float = 0.0


@dataclass
class BatchnormSpec:
    dim: int
    target_rms: float = 1.0
    epsilon: float = 1e-3


@dataclass
class SpecAugmentSpec:
    dim: int
    freq_max_proportion: float = 0.5
    time_zeroed_proportion: float = 0.0
    time_mask_max_frames: int = 20


@dataclass
class CombineFeatureMapsSpec:
    num_filters1: int
    num_filters2: int
    num_filters3: int
    height: int
    input_dim: int


@dataclass
class ConvReluBNSpec:
    height_in: int
    height_out: int
    height_subsample: int
    time_offsets: List[int]
    height_offsets: List[int]
    num_filters_in: int
    num_filters_out: int
    input_dim: int
    output_dim: int
    target_rms: float = 1.0
    l2_reg: float = 0.0
    learning_rate_factor: float = 1.0
    max_change: float = 0.75

    @property
    def offsets(self) -> List[Tuple[int, int]]:
        """Cartesian (time, height) offset pairs, Kaldi <Offsets> order
        (time-major, height fastest)."""
        return [(t, h) for t in self.time_offsets for h in self.height_offsets]


@dataclass
class TDNNFSpec:
    input_dim: int
    output_dim: int
    bottleneck_dim: int
    time_stride: int = 3
    bypass_scale: float = 0.66
    target_rms: float = 1.0
    l2_reg: float = 0.0
    # Kaldi tdnnf-layer default: the bottleneck linear is kept
    # semi-orthogonal with a FLOATING scale (Povey et al. 2018).  The
    # reference parses this option but never applies it
    # (layers.go:45,221 — no other use); here training/orthonormal.py
    # enforces it every TrainConfig.orthonormal_interval steps.
    orthonormal_constraint: float = -1.0


@dataclass
class AttentionSpec:
    input_dim: int
    output_dim: int
    num_heads: int
    value_dim: int
    key_dim: int
    num_left_inputs: int
    num_right_inputs: int
    context_dim: int
    time_stride: int = 1
    target_rms: float = 1.0
    l2_reg: float = 0.0

    @property
    def key_scale(self) -> float:
        return 1.0 / math.sqrt(self.key_dim)

    @property
    def query_dim(self) -> int:
        return self.key_dim + self.context_dim

    @property
    def input_dim_per_head(self) -> int:
        return self.key_dim + self.value_dim + self.query_dim

    @property
    def output_dim_per_head(self) -> int:
        return self.value_dim + self.context_dim


@dataclass
class ReluBatchnormSpec:
    """Kaldi relu-batchnorm-layer: affine -> ReLU -> batchnorm
    (standard recipe layer; produces name.affine/.relu/.batchnorm
    components in Kaldi)."""
    input_dim: int
    output_dim: int
    target_rms: float = 1.0
    l2_reg: float = 0.0
    max_change: float = 0.75


@dataclass
class PrefinalSpec:
    input_dim: int
    small_dim: int
    big_dim: int
    target_rms: float = 1.0
    l2_reg: float = 0.0
    # Kaldi prefinal-layer: the big->small linear carries a floating
    # semi-orthogonal constraint by default (see TDNNFSpec note)
    orthonormal_constraint: float = -1.0


@dataclass
class OutputSpec:
    input_dim: int
    output_dim: int
    include_log_softmax: bool = True
    l2_reg: float = 0.0
    learning_rate_factor: float = 1.0
    max_change: float = 1.5
    # Kaldi's output-delay: the output at t reads its input at t - delay
    output_delay: int = 0


@dataclass
class FixedAffineSpec:
    """Kaldi fixed-affine-layer (the LDA): y = x W + b with W and b held
    fixed.  Kaldi reads them from affine-transform-file; the port holds
    them as parameters that the caller sets (Xavier-drawn until then)."""
    input_dim: int
    output_dim: int
    affine_file: str = ""


@dataclass
class ReluRenormSpec:
    """Kaldi relu-renorm-layer: affine, ReLU, NormalizeComponent
    (y = x (mean(x^2) / target_rms^2 + 2^-66)^-1/2 per frame)."""
    input_dim: int
    output_dim: int
    target_rms: float = 1.0
    l2_reg: float = 0.0


@dataclass
class FastLstmpSpec:
    """Kaldi fast-lstmp-layer: W_all over [x_t ; s r_{t+delay}] into the
    gates i, f, g, o, the peepholes w_ic, w_fc, w_oc, the cell and W_rp into
    [r_t ; p_t]; the layer's output is [r_t ; p_t].  A negative delay walks
    forward in time, a positive one backward (a BLSTM's backward layer).  The recurrence's
    BackpropTruncationComponent scales c and r by `scale` both ways and, in
    the backward, clips each frame's [c ; r] derivative row to
    clipping_threshold and zeroes one above zeroing_threshold on the frames
    that cross a multiple of zeroing_interval."""
    input_dim: int
    cell_dim: int
    recurrent_dim: int
    nonrecurrent_dim: int
    delay: int = -1
    decay_time: float = -1.0
    clipping_threshold: float = 30.0
    zeroing_threshold: float = 15.0
    zeroing_interval: int = 20
    l2_reg: float = 0.0

    @property
    def output_dim(self) -> int:
        return self.recurrent_dim + self.nonrecurrent_dim

    @property
    def scale(self) -> float:
        """1 - |delay| / decay-time (1 without a decay time)."""
        if self.decay_time < 0:
            return 1.0
        return 1.0 - abs(self.delay) / self.decay_time


@dataclass
class InputLayerSpec:
    dim: int


@dataclass
class Layer:
    name: str
    type: LayerType
    config: LayerConfig
    input: InputSpec
    input_dim: int
    output_dim: int
    spec: object


def resolve_layer_name(name: str, layer_map: Dict[str, "Layer"]) -> Optional["Layer"]:
    """Exact match, else dotted-suffix prefix match taking the latest
    (ref: layers.go:357-374)."""
    if name in layer_map:
        return layer_map[name]
    best = None
    for lname, l in layer_map.items():
        if lname.startswith(name + "."):
            if best is None or l.config.line > best.config.line:
                best = l
    return best


def resolve_layers(configs: List[LayerConfig]) -> List[Layer]:
    layer_map: Dict[str, Layer] = {}
    layers: List[Layer] = []
    for idx, cfg in enumerate(configs):
        layer = _resolve_one(cfg, layer_map, layers, idx)
        layers.append(layer)
        layer_map[layer.name] = layer
    return layers


def _resolve_input(cfg: LayerConfig, layer_map, layers, idx) -> InputSpec:
    ref = parse_input(cfg.input_spec())
    spec = InputSpec(ref=ref)
    if ref.type == InputType.PREVIOUS:
        if idx > 0:
            prev = layers[idx - 1]
            spec.names = [prev.name]
            spec.dim = prev.output_dim
    elif ref.type == InputType.SIMPLE:
        src = resolve_layer_name(ref.name, layer_map)
        if src is None:
            raise ValueError(f"layer {cfg.name}: input {ref.name!r} not found")
        spec.names = [src.name]
        spec.dim = src.output_dim
    elif ref.type == InputType.APPEND:
        total = 0
        for n, off in zip(ref.names, ref.offsets):
            if not n:                   # an offset of the previous layer
                if idx == 0:
                    raise ValueError(f"layer {cfg.name}: an offset needs a "
                                     "previous layer")
                src = layers[idx - 1]
            else:
                inner = parse_input(n)
                src_name = (inner.source if inner.type == InputType.REPLACE_INDEX
                            else n)
                src = resolve_layer_name(src_name, layer_map)
            if src is None:
                raise ValueError(f"layer {cfg.name}: append input {n!r} not found")
            spec.names.append(src.name)
            spec.offsets.append(off)
            total += src.output_dim
        spec.dim = total
    elif ref.type == InputType.REPLACE_INDEX:
        src = resolve_layer_name(ref.source, layer_map)
        if src is None:
            raise ValueError(f"layer {cfg.name}: input {ref.source!r} not found")
        spec.names = [src.name]
        spec.dim = src.output_dim
    if not spec.offsets:
        spec.offsets = [0] * len(spec.names)
    return spec


def _resolve_one(cfg: LayerConfig, layer_map, layers, idx) -> Layer:
    inp = _resolve_input(cfg, layer_map, layers, idx)
    t = cfg.type

    if t == LayerType.INPUT:
        dim = cfg.get_int("dim")
        if dim <= 0:
            raise ValueError(f"input layer {cfg.name}: missing dim")
        return Layer(cfg.name, t, cfg, inp, dim, dim, InputLayerSpec(dim))

    if t == LayerType.IDCT:
        dim = cfg.get_int("dim", inp.dim)
        spec = IDCTSpec(dim=dim,
                        cepstral_lifter=cfg.get_float("cepstral-lifter", 22.0),
                        affine_file=cfg.get_str("affine-transform-file"))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.LINEAR:
        dim = cfg.get_int("dim")
        if dim <= 0:
            raise ValueError(f"linear-component {cfg.name}: missing dim")
        spec = LinearSpec(inp.dim, dim, l2_reg=cfg.get_float("l2-regularize"),
                          orthonormal_constraint=cfg.get_float("orthonormal-constraint"))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.BATCHNORM:
        spec = BatchnormSpec(inp.dim, target_rms=cfg.get_float("target-rms", 1.0))
        return Layer(cfg.name, t, cfg, inp, inp.dim, inp.dim, spec)

    if t == LayerType.SPEC_AUGMENT:
        spec = SpecAugmentSpec(
            inp.dim,
            freq_max_proportion=cfg.get_float("freq-max-proportion", 0.5),
            time_zeroed_proportion=cfg.get_float("time-zeroed-proportion", 0.0),
            time_mask_max_frames=cfg.get_int("time-mask-max-frames", 20))
        return Layer(cfg.name, t, cfg, inp, inp.dim, inp.dim, spec)

    if t == LayerType.COMBINE_FEATURE_MAPS:
        height = cfg.get_int("height")
        spec = CombineFeatureMapsSpec(
            num_filters1=cfg.get_int("num-filters1", 1),
            num_filters2=cfg.get_int("num-filters2", 1),
            num_filters3=cfg.get_int("num-filters3", 0),
            height=height, input_dim=inp.dim)
        return Layer(cfg.name, t, cfg, inp, inp.dim, inp.dim, spec)

    if t == LayerType.CONV_RELU_BATCHNORM:
        height_in = cfg.get_int("height-in")
        height_out = cfg.get_int("height-out", height_in)
        nf_out = cfg.get_int("num-filters-out")
        nf_in = inp.dim // height_in if height_in > 0 else 0
        spec = ConvReluBNSpec(
            height_in=height_in, height_out=height_out,
            height_subsample=cfg.get_int("height-subsample-out", 1),
            time_offsets=cfg.get_int_list("time-offsets") or [0],
            height_offsets=cfg.get_int_list("height-offsets") or [0],
            num_filters_in=nf_in, num_filters_out=nf_out,
            input_dim=inp.dim, output_dim=height_out * nf_out,
            target_rms=cfg.get_float("target-rms", 1.0),
            l2_reg=cfg.get_float("l2-regularize"),
            learning_rate_factor=cfg.get_float("learning-rate-factor", 1.0),
            max_change=cfg.get_float("max-change", 0.75))
        return Layer(cfg.name, t, cfg, inp, inp.dim, spec.output_dim, spec)

    if t == LayerType.TDNNF:
        dim = cfg.get_int("dim")
        bn = cfg.get_int("bottleneck-dim")
        if dim <= 0 or bn <= 0:
            raise ValueError(f"tdnnf-layer {cfg.name}: missing dim/bottleneck-dim")
        spec = TDNNFSpec(inp.dim, dim, bn,
                         time_stride=cfg.get_int("time-stride", 3),
                         bypass_scale=cfg.get_float("bypass-scale", 0.66),
                         l2_reg=cfg.get_float("l2-regularize"),
                         orthonormal_constraint=cfg.get_float(
                             "orthonormal-constraint", -1.0))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.ATTENTION_RELU_BATCHNORM:
        heads = cfg.get_int("num-heads", 1)
        value_dim = cfg.get_int("value-dim")
        key_dim = cfg.get_int("key-dim")
        nl = cfg.get_int("num-left-inputs")
        nr = cfg.get_int("num-right-inputs")
        ctx = 1 + nl + nr
        out_dim = heads * (value_dim + ctx)
        spec = AttentionSpec(inp.dim, out_dim, heads, value_dim, key_dim,
                             nl, nr, ctx,
                             time_stride=cfg.get_int("time-stride", 1),
                             l2_reg=cfg.get_float("l2-regularize"))
        return Layer(cfg.name, t, cfg, inp, inp.dim, out_dim, spec)

    if t == LayerType.RELU_BATCHNORM:
        dim = cfg.get_int("dim")
        if dim <= 0:
            raise ValueError(f"relu-batchnorm-layer {cfg.name}: missing dim")
        spec = ReluBatchnormSpec(inp.dim, dim,
                                 target_rms=cfg.get_float("target-rms", 1.0),
                                 l2_reg=cfg.get_float("l2-regularize"),
                                 max_change=cfg.get_float("max-change", 0.75))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.PREFINAL:
        small = cfg.get_int("small-dim")
        big = cfg.get_int("big-dim")
        if small <= 0 or big <= 0:
            raise ValueError(f"prefinal-layer {cfg.name}: missing small-dim/big-dim")
        spec = PrefinalSpec(inp.dim, small, big,
                            l2_reg=cfg.get_float("l2-regularize"),
                            orthonormal_constraint=cfg.get_float(
                                "orthonormal-constraint", -1.0))
        return Layer(cfg.name, t, cfg, inp, inp.dim, small, spec)

    if t == LayerType.OUTPUT:
        dim = cfg.get_int("dim")
        if dim <= 0:
            raise ValueError(f"output-layer {cfg.name}: missing dim")
        spec = OutputSpec(inp.dim, dim,
                          include_log_softmax=cfg.get_bool("include-log-softmax", True),
                          l2_reg=cfg.get_float("l2-regularize"),
                          learning_rate_factor=cfg.get_float("learning-rate-factor", 1.0),
                          max_change=cfg.get_float("max-change", 1.5),
                          output_delay=cfg.get_int("output-delay", 0))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.FIXED_AFFINE:
        dim = cfg.get_int("dim", inp.dim)
        spec = FixedAffineSpec(inp.dim, dim,
                               affine_file=cfg.get_str("affine-transform-file"))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.RELU_RENORM:
        dim = cfg.get_int("dim")
        if dim <= 0:
            raise ValueError(f"relu-renorm-layer {cfg.name}: missing dim")
        spec = ReluRenormSpec(inp.dim, dim,
                              target_rms=cfg.get_float("target-rms", 1.0),
                              l2_reg=cfg.get_float("l2-regularize"))
        return Layer(cfg.name, t, cfg, inp, inp.dim, dim, spec)

    if t == LayerType.FAST_LSTMP:
        cell = cfg.get_int("cell-dim")
        rec = cfg.get_int("recurrent-projection-dim", cell // 4)
        nonrec = cfg.get_int("non-recurrent-projection-dim", cell // 4)
        if cell <= 0 or rec <= 0 or nonrec < 0:
            raise ValueError(f"fast-lstmp-layer {cfg.name}: need cell-dim > 0 "
                             "and recurrent-projection-dim > 0")
        spec = FastLstmpSpec(
            inp.dim, cell, rec, nonrec,
            delay=cfg.get_int("delay", -1),
            decay_time=cfg.get_float("decay-time", -1.0),
            clipping_threshold=cfg.get_float("clipping-threshold", 30.0),
            zeroing_threshold=cfg.get_float("zeroing-threshold", 15.0),
            zeroing_interval=cfg.get_int("zeroing-interval", 20),
            l2_reg=cfg.get_float("l2-regularize"))
        if spec.delay == 0:
            raise ValueError(f"fast-lstmp-layer {cfg.name}: delay must be "
                             "nonzero (negative: a forward recurrence, "
                             "positive: a reverse one)")
        if spec.scale <= 0:
            raise ValueError(f"fast-lstmp-layer {cfg.name}: decay-time must "
                             "exceed |delay|")
        return Layer(cfg.name, t, cfg, inp, inp.dim, spec.output_dim, spec)

    raise ValueError(f"unsupported layer type: {t}")
