"""Model container: resolved layers + execution order + summaries.

(ref: internal/nnet/model.go — the xconfig order is already topological,
model.go:259-269.)

Copy of kaldi_fp16_tpu/models/model.py (pure Python, see xconfig.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kaldi_fp16_tpu_torch.models.xconfig import LayerType, parse_xconfig, parse_xconfig_file
from kaldi_fp16_tpu_torch.models.layers import (
    Layer, resolve_layers,
    ConvReluBNSpec, TDNNFSpec, AttentionSpec, PrefinalSpec, OutputSpec,
    LinearSpec, IDCTSpec, FastLstmpSpec, ReluRenormSpec,
)


@dataclass
class Model:
    layers: List[Layer]
    layer_map: Dict[str, Layer] = field(default_factory=dict)

    def __post_init__(self):
        if not self.layer_map:
            self.layer_map = {l.name: l for l in self.layers}

    def execution_order(self) -> List[Layer]:
        return self.layers  # xconfig is topological by construction

    def inputs(self) -> List[Layer]:
        return [l for l in self.layers if l.type == LayerType.INPUT]

    def outputs(self) -> List[Layer]:
        return [l for l in self.layers if l.type == LayerType.OUTPUT]

    def chain_output(self) -> Optional[Layer]:
        """The chain head: the output named 'output', else the first output
        without log-softmax (ref: model.go:272-292)."""
        for l in self.outputs():
            if l.name == "output":
                return l
        for l in self.outputs():
            if not l.spec.include_log_softmax:
                return l
        outs = self.outputs()
        return outs[0] if outs else None

    def xent_output(self) -> Optional[Layer]:
        for l in self.outputs():
            if l.name == "output-xent":
                return l
        for l in self.outputs():
            if l.spec.include_log_softmax and l is not self.chain_output():
                return l
        return None

    def num_params(self) -> int:
        total = 0
        for l in self.layers:
            s = l.spec
            if isinstance(s, IDCTSpec):
                pass  # fixed matrix, not trainable
            elif isinstance(s, LinearSpec):
                total += s.input_dim * s.output_dim
            elif isinstance(s, ConvReluBNSpec):
                total += (len(s.offsets) * s.num_filters_in * s.num_filters_out
                          + s.num_filters_out)
            elif isinstance(s, TDNNFSpec):
                lin_in = s.input_dim * (2 if s.time_stride > 0 else 1)
                aff_in = s.bottleneck_dim * (2 if s.time_stride > 0 else 1)
                total += lin_in * s.bottleneck_dim
                total += aff_in * s.output_dim + s.output_dim
            elif isinstance(s, AttentionSpec):
                total += s.input_dim * s.num_heads * s.input_dim_per_head
                total += s.num_heads * s.input_dim_per_head
            elif isinstance(s, PrefinalSpec):
                total += s.input_dim * s.big_dim + s.big_dim
                total += s.big_dim * s.small_dim
            elif isinstance(s, (OutputSpec, ReluRenormSpec)):
                total += s.input_dim * s.output_dim + s.output_dim
            elif isinstance(s, FastLstmpSpec):
                gates = 4 * s.cell_dim
                total += (s.input_dim + s.recurrent_dim + 1) * gates
                total += 3 * s.cell_dim                      # peepholes
                total += (s.cell_dim + 1) * s.output_dim
        return total

    def time_context(self) -> tuple:
        """(left, right) INPUT-frame receptive-field radius of the net.

        Upper bound by summing each layer's temporal reach along the
        execution order (branches/bypass can only need less): conv
        time-offsets, TDNN-F's two one-sided splices (±time_stride),
        restricted attention's num-left/right-inputs x time_stride.
        Used by the streaming encoder (decode/streaming.py) to size the
        per-chunk context overlap — an over-estimate costs overlap
        compute, never correctness.  (The reference never computes this:
        its egs arrive pre-chunked with context baked in — docs
        kaldi-egs-format.md t=-31..171; this is the serving-side
        equivalent.)

        An Append's time offsets add their reach; a fast-lstmp layer adds
        none (its recurrence reads the past, or with a positive delay the
        future, only where it is defined, Kaldi's IfDefined); the outputs' output-delay moves the context
        left, once (the largest delay)."""
        left = right = 0
        for l in self.layers:
            s = l.spec
            offs = l.input.offsets
            if offs:
                left += max(0, -min(offs))
                right += max(0, max(offs))
            if isinstance(s, ConvReluBNSpec):
                left += max(0, -min(s.time_offsets))
                right += max(0, max(s.time_offsets))
            elif isinstance(s, TDNNFSpec):
                left += s.time_stride
                right += s.time_stride
            elif isinstance(s, AttentionSpec):
                left += s.num_left_inputs * s.time_stride
                right += s.num_right_inputs * s.time_stride
        delay = max([o.spec.output_delay for o in self.outputs()], default=0)
        return left + delay, max(0, right - delay)

    def summary(self) -> str:
        lines = [f"{'#':>3} {'name':<22} {'type':<28} {'in':>6} {'out':>6}  input"]
        for i, l in enumerate(self.layers):
            src = ",".join(l.input.names) if l.input.names else "-"
            lines.append(f"{i:>3} {l.name:<22} {l.type.value:<28} "
                         f"{l.input_dim:>6} {l.output_dim:>6}  {src}")
        lines.append(f"total params: {self.num_params():,}")
        return "\n".join(lines)


def build_model_from_string(xconfig_text: str) -> Model:
    return Model(resolve_layers(parse_xconfig(xconfig_text)))


def build_model(xconfig_path: str) -> Model:
    return Model(resolve_layers(parse_xconfig_file(xconfig_path)))
