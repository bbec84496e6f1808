"""FLOPs of one training step of an xconfig network, from its layer shapes.

Counted: every matmul and convolution of the forward (2 x rows x in x out),
the weight gradient of every trainable one, and the input gradient of every
one whose input carries a gradient to a trainable leaf; attention's score
and value products.  Elementwise work (BatchNorm, relu, SpecAugment) and
recomputation are not counted.  Rows are the frames a layer runs at: the
input rate, or the supervision grid for the layers on it (and for the cut
convs, which emit grid frames).  The fixed IDCT counts its forward only.
"""

from __future__ import annotations

from benchmark.reference.network import _grid_base, conv_cut_layers
from benchmark.reference.xconfig import InputType, LayerType


def _matmuls(layer):
    """[(in, out, kind)] of a layer's products per output frame."""
    s, t = layer.spec, layer.type
    if t == LayerType.IDCT:
        return [(s.dim, s.dim, "fixed")]
    if t == LayerType.LINEAR:
        return [(s.input_dim, s.output_dim, "w")]
    if t == LayerType.CONV_RELU_BATCHNORM:
        k = len(s.time_offsets) * len(s.height_offsets) * s.num_filters_in
        return [(k * s.height_out, s.num_filters_out, "conv")]
    if t == LayerType.TDNNF:
        m = 2 if s.time_stride > 0 else 1
        return [(s.input_dim * m, s.bottleneck_dim, "w"),
                (s.bottleneck_dim * m, s.output_dim, "w")]
    if t in (LayerType.RELU_BATCHNORM, LayerType.OUTPUT):
        return [(s.input_dim, s.output_dim, "w")]
    if t == LayerType.PREFINAL:
        return [(s.input_dim, s.big_dim, "w"), (s.big_dim, s.small_dim, "w")]
    if t == LayerType.ATTENTION_RELU_BATCHNORM:
        proj = s.num_heads * s.input_dim_per_head
        ctx = s.num_heads * s.context_dim * (s.key_dim + s.value_dim)
        return [(s.input_dim, proj, "w"), (ctx, 1, "attn")]
    return []


def step_flops(model, batch: int, frames_in: int, stride: int,
               grid: bool = True, cut_convs: bool = True) -> float:
    """FLOPs of one forward + backward of `model` at [batch, frames_in]."""
    n_grid = (frames_in - stride) // stride + 1
    on_grid = _grid_base(model, stride) if grid else frozenset()
    cut = conv_cut_layers(model, stride) if grid and cut_convs else frozenset()
    needs_grad = set()          # layers whose output carries a gradient
    total = 0.0
    prev = None
    for layer in model.execution_order():
        if layer.type == LayerType.INPUT:
            prev = layer.name
            continue
        names = ([prev] if layer.input.ref.type == InputType.PREVIOUS
                 else list(layer.input.names))
        grad_in = any(n in needs_grad for n in names)
        rows = batch * (n_grid if layer.name in on_grid or layer.name in cut
                        else frames_in)
        trainable = False
        for fan_in, fan_out, kind in _matmuls(layer):
            f = 2.0 * rows * fan_in * fan_out
            if kind == "fixed":
                total += f
                continue
            if kind == "attn":
                total += 3.0 * f                # forward, two backward
                continue
            trainable = True
            total += 2.0 * f                    # forward, weight gradient
            if grad_in:
                total += f                      # input gradient
        if trainable or grad_in:
            needs_grad.add(layer.name)
        prev = layer.name
    return total
