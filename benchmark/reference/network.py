"""Plain reference of the xconfig network's training forward.

A frozen, single-process copy of kaldi_fp16_tpu_torch/models/network.py at
commit de5aca0 (its `group=None` path), so that a later change to the port
cannot move the benchmark's yardstick.  What is kept is the arithmetic the
port's forward defines: Kaldi BatchNorm over (batch, time) with a Chan
merge into the running statistics, SpecAugment masks drawn from a
generator in the port's order, the frame grid (grid-eligible layers run
only at the supervision frame rate, their BatchNorm statistics taken over
those frames) and the cut convs (a conv that feeds the grid emits only grid
frames), the TDNN-F bottleneck and bypass, restricted attention, the
prefinal and output heads, and the natural-gradient sites (the matmul
input X and the gradient G of each site's pre-activation output).

It computes in float32, or, for the benchmark's control, with every matmul
and conv operand rounded to float8 e4m3 and the gradients flowing back into
them to e5m2 (one scale per tensor) by `quant`.
There is no bf16 cast between layers: that is the program's precision, not
the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import Layer
from .model import Model
from .xconfig import InputType, LayerType

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _round_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 `dtype`, one scale per tensor (amax -> top),
    returned in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand in float8 e4m3.  Backward: the gradient that
    reaches it in float8 e5m2, as fp8 training rounds them."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """The control's operand precision: every matmul and conv operand in
    float8 e4m3 and the gradients that flow back into them in e5m2, one
    scale per tensor, float32 elsewhere."""
    return _Fp8Operand.apply(t.float())


def bf16_quant(t: torch.Tensor) -> torch.Tensor:
    """Every matmul and conv operand rounded to bf16 (the program's
    precision; a witness for calibration, never the comparison's side)."""
    return t.to(torch.bfloat16).float()


def _op(t: torch.Tensor, quant: Quant) -> torch.Tensor:
    return t.float() if quant is None else quant(t)


def _mm(x, w, quant: Quant):
    return torch.matmul(_op(x, quant), _op(w, quant))


def make_idct_matrix(dim: int, cepstral_lifter: float) -> np.ndarray:
    mat = np.zeros((dim, dim), dtype=np.float64)
    for i in range(dim):
        lc = 1.0
        if cepstral_lifter > 0 and i > 0:
            lc = 1.0 + (cepstral_lifter / 2.0) * math.sin(
                math.pi * i / cepstral_lifter)
        norm = math.sqrt((1.0 if i == 0 else 2.0) / dim)
        for j in range(dim):
            mat[i, j] = norm * math.cos(math.pi * i * (j + 0.5) / dim) / lc
    return mat.astype(np.float32)


def conv_weight_from_oihw(w, spec):
    return w.permute(2, 3, 1, 0).reshape(-1, spec.num_filters_out)


def conv_weight_to_oihw(w, spec):
    kt, kh = len(spec.time_offsets), len(spec.height_offsets)
    return (w.reshape(kt, kh, spec.num_filters_in, spec.num_filters_out)
            .permute(3, 2, 0, 1).contiguous())


def param_shapes(model: Model) -> Dict[str, Dict[str, tuple]]:
    """{layer: {name: shape}} of the trainable leaves, in the port's layout
    (matmul weights [in, out], conv weights OIHW), and the xavier fans of
    each weight: the benchmark draws its weights from these."""
    out = {}
    for layer in model.execution_order():
        s, t = layer.spec, layer.type
        if t == LayerType.LINEAR:
            p = {"w": (s.input_dim, s.output_dim)}
        elif t == LayerType.CONV_RELU_BATCHNORM:
            p = {"w": (s.num_filters_out, s.num_filters_in,
                       len(s.time_offsets), len(s.height_offsets)),
                 "b": (s.num_filters_out,)}
        elif t == LayerType.TDNNF:
            m = 2 if s.time_stride > 0 else 1
            p = {"linear_w": (s.input_dim * m, s.bottleneck_dim),
                 "affine_w": (s.bottleneck_dim * m, s.output_dim),
                 "affine_b": (s.output_dim,)}
        elif t in (LayerType.RELU_BATCHNORM, LayerType.OUTPUT):
            p = {"w": (s.input_dim, s.output_dim), "b": (s.output_dim,)}
        elif t == LayerType.PREFINAL:
            p = {"big_w": (s.input_dim, s.big_dim), "big_b": (s.big_dim,),
                 "small_w": (s.big_dim, s.small_dim)}
        elif t == LayerType.ATTENTION_RELU_BATCHNORM:
            proj = s.num_heads * s.input_dim_per_head
            p = {"w": (s.input_dim, proj), "b": (proj,)}
        else:
            continue
        out[layer.name] = p
    return out


def bn_dims(layer: Layer) -> Dict[str, int]:
    s, t = layer.spec, layer.type
    if t == LayerType.BATCHNORM:
        return {"bn": s.dim}
    if t in (LayerType.CONV_RELU_BATCHNORM, LayerType.TDNNF,
             LayerType.RELU_BATCHNORM, LayerType.ATTENTION_RELU_BATCHNORM):
        return {"bn": s.output_dim}
    if t == LayerType.PREFINAL:
        return {"bn1": s.big_dim, "bn2": s.small_dim}
    return {}


def init_bn_state(model: Model, device) -> dict:
    def one(dim):
        return {"count": torch.zeros((), device=device),
                "mean": torch.zeros(dim, device=device),
                "var": torch.ones(dim, device=device)}
    state = {}
    for layer in model.execution_order():
        dims = bn_dims(layer)
        if "bn" in dims:
            state[layer.name] = one(dims["bn"])
        elif dims:
            state[layer.name] = {k: one(v) for k, v in dims.items()}
    return state


def _merge_running(st, mean, var, n):
    with torch.no_grad():
        old_n = st["count"]
        count = old_n + n
        delta = mean.detach() - st["mean"]
        new_mean = st["mean"] + delta * (n / count)
        new_var = (old_n * st["var"] + n * var.detach()
                   + delta * delta * old_n * n / count) / count
    return {"count": count, "mean": new_mean, "var": new_var}


def _batchnorm(x, st, target_rms, epsilon):
    mean = x.mean(dim=(0, 1))
    var = torch.clamp(x.var(dim=(0, 1), unbiased=False), min=0.0)
    new_state = _merge_running(st, mean, var, float(x.shape[0] * x.shape[1]))
    scale = target_rms * torch.rsqrt(var + epsilon)
    return (x - mean) * scale, new_state


def _shift_time(x, offset, mode):
    if offset == 0:
        return x
    T = x.shape[1]
    k = abs(offset)
    if mode == "zero":
        fill = torch.zeros_like(x[:, :1]).expand(-1, k, *x.shape[2:])
        if offset > 0:
            return torch.cat([x[:, offset:], fill], dim=1)
        return torch.cat([fill, x[:, :T + offset]], dim=1)
    if offset > 0:
        return torch.cat([x[:, offset:],
                          x[:, -1:].expand(-1, k, *x.shape[2:])], dim=1)
    return torch.cat([x[:, :1].expand(-1, k, *x.shape[2:]),
                      x[:, :T + offset]], dim=1)


def _splice(x, offsets, mode):
    return torch.cat([_shift_time(x, o, mode) for o in offsets], dim=-1)


def _even_spacing(offsets):
    if len(offsets) == 1:
        return 1
    d = offsets[1] - offsets[0]
    if d <= 0 or any(offsets[i + 1] - offsets[i] != d
                     for i in range(len(offsets) - 1)):
        return None
    return d


def _direct_conv_ok(spec):
    return (_even_spacing(spec.time_offsets) is not None
            and _even_spacing(spec.height_offsets) is not None
            and min(spec.time_offsets) <= 0
            and min(spec.height_offsets) <= 0 <= max(spec.height_offsets))


class NGContext:
    """Each natural-gradient site's matmul input X and the gradient G of
    its pre-activation output."""

    def __init__(self):
        self.xs: Dict[str, torch.Tensor] = {}
        self.gs: Dict[str, torch.Tensor] = {}

    def site(self, name, x, out):
        self.xs[name] = x.detach()
        if out.requires_grad:
            out.register_hook(lambda g, name=name: self.gs.__setitem__(name, g))
        return out


def _site(ng, name, x, out):
    return out if ng is None else ng.site(name, x, out)


def ng_sites(model: Model):
    sites = []
    for layer in model.layers:
        t, sp, n = layer.type, layer.spec, layer.name
        if t == LayerType.LINEAR:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b=None,
                              in_dim=sp.input_dim, out_dim=sp.output_dim))
        elif t == LayerType.RELU_BATCHNORM:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=sp.output_dim))
        elif t == LayerType.CONV_RELU_BATCHNORM:
            k = len(sp.offsets) * sp.num_filters_in
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=k, out_dim=sp.num_filters_out))
        elif t == LayerType.TDNNF:
            m = 2 if sp.time_stride > 0 else 1
            sites.append(dict(name=f"{n}/linear_w", layer=n, w="linear_w",
                              b=None, in_dim=sp.input_dim * m,
                              out_dim=sp.bottleneck_dim))
            sites.append(dict(name=f"{n}/affine_w", layer=n, w="affine_w",
                              b="affine_b", in_dim=sp.bottleneck_dim * m,
                              out_dim=sp.output_dim))
        elif t == LayerType.ATTENTION_RELU_BATCHNORM:
            proj = sp.num_heads * sp.input_dim_per_head
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=proj))
        elif t == LayerType.PREFINAL:
            sites.append(dict(name=f"{n}/big_w", layer=n, w="big_w",
                              b="big_b", in_dim=sp.input_dim,
                              out_dim=sp.big_dim))
            sites.append(dict(name=f"{n}/small_w", layer=n, w="small_w",
                              b=None, in_dim=sp.big_dim,
                              out_dim=sp.small_dim))
        elif t == LayerType.OUTPUT:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=sp.output_dim))
    return sites


def _conv(spec, p, st, x, quant, ng, lname, grid_cut):
    """Conv-relu-BatchNorm over (time, height), x [B, T, H_in * nf_in]
    filter fastest.  With NG the patch matmul (X is the patch), else one
    F.conv2d; grid_cut=(stride, offset, n_grid) keeps only the grid frames
    before the relu and BatchNorm."""
    B, T, _ = x.shape
    H_in, H_out = spec.height_in, spec.height_out
    nf_in, nf_out = spec.num_filters_in, spec.num_filters_out
    sub = spec.height_subsample
    h_offs, t_offs = spec.height_offsets, spec.time_offsets
    pad_lo = max(0, -min(h_offs))
    pad_hi = max(0, (H_out - 1) * sub + max(h_offs) - (H_in - 1))
    if ng is not None or not _direct_conv_ok(spec):
        patches = []
        for o in t_offs:
            xt = _shift_time(x, o, "zero").reshape(B, T, H_in, nf_in)
            if pad_lo or pad_hi:
                xt = F.pad(xt, (0, 0, pad_lo, pad_hi))
            for h_off in h_offs:
                start = pad_lo + h_off
                patches.append(xt[:, :, start:start + (H_out - 1) * sub + 1:sub])
        patch = torch.cat(patches, dim=-1)
        out = _mm(patch, conv_weight_from_oihw(p["w"], spec), quant) + p["b"]
        out = _site(ng, f"{lname}/w", patch, out)
        out = torch.relu(out).reshape(B, T, H_out * nf_out)
    else:
        t_lo, t_hi = -min(t_offs), max(t_offs)
        dilation = (_even_spacing(t_offs), _even_spacing(h_offs))
        xs = _op(x, quant).reshape(B, T, H_in, nf_in).permute(0, 3, 1, 2)
        xpad = F.pad(xs, (pad_lo, pad_hi, t_lo, t_hi))
        out = F.conv2d(xpad, _op(p["w"], quant), stride=(1, sub),
                       dilation=dilation)
        out = out[:, :, :T, :H_out] + p["b"][None, :, None, None]
        out = torch.relu(out).permute(0, 2, 3, 1).reshape(B, T, H_out * nf_out)
    if grid_cut is not None:
        stride, off, n = grid_cut
        out = out[:, off:off + (n - 1) * stride + 1:stride]
    return _batchnorm(out, st, spec.target_rms, 1e-3)


def _tdnnf(spec, p, st, x, quant, ng, lname):
    s = spec.time_stride
    lin_in = _splice(x, (-s, 0), "clamp") if s > 0 else x
    bottleneck = _site(ng, f"{lname}/linear_w", lin_in,
                       _mm(lin_in, p["linear_w"], quant))
    aff_in = _splice(bottleneck, (0, s), "clamp") if s > 0 else bottleneck
    out = _mm(aff_in, p["affine_w"], quant) + p["affine_b"]
    out = _site(ng, f"{lname}/affine_w", aff_in, out)
    out, new_bn = _batchnorm(torch.relu(out), st, spec.target_rms, 1e-3)
    if spec.bypass_scale > 0 and spec.input_dim == spec.output_dim:
        out = out + spec.bypass_scale * x
    return out, new_bn


def _attention(spec, p, st, x, quant, ng, lname):
    B, T, _ = x.shape
    H, kd, vd = spec.num_heads, spec.key_dim, spec.value_dim
    cd = spec.context_dim
    proj = _mm(x, p["w"], quant) + p["b"]
    proj = _site(ng, f"{lname}/w", x, proj)
    proj = proj.reshape(B, T, H, spec.input_dim_per_head)
    keys = proj[..., :kd]
    values = proj[..., kd:kd + vd]
    q_key = proj[..., kd + vd:kd + vd + kd]
    q_ctx = proj[..., kd + vd + kd:]
    deltas = [(o - spec.num_left_inputs) * spec.time_stride
              for o in range(cd)]
    scores = [q_ctx[..., o] + spec.key_scale
              * (q_key * _shift_time(keys, d, "zero")).sum(-1)
              for o, d in enumerate(deltas)]
    attn = torch.softmax(torch.stack(scores, dim=-1), dim=-1)
    vals = torch.stack([_shift_time(values, d, "zero") for d in deltas],
                       dim=-2)
    ctx_out = torch.einsum("bthc,bthcv->bthv", attn, vals)
    out = torch.cat([ctx_out, attn], dim=-1).reshape(B, T, H * (vd + cd))
    return _batchnorm(torch.relu(out), st, spec.target_rms, 1e-3)


def spec_augment_masks(spec, B, T, generator, device):
    """SpecAugment keep-masks, drawn from `generator` in the port's order."""
    D = spec.dim
    gdev = generator.device

    def randint(high, size):
        return torch.randint(0, high, size, generator=generator,
                             device=gdev).to(device)

    f_keep = t_keep = None
    max_w = int(spec.freq_max_proportion * D)
    if max_w > 0:
        width = randint(max_w + 1, (B,))
        start = randint(D, (B,))
        f_idx = torch.arange(D, device=device)[None, :]
        f_keep = ~((f_idx >= start[:, None])
                   & (f_idx < (start + width)[:, None]))
    if spec.time_zeroed_proportion > 0:
        n_masks = max(1, int(T * spec.time_zeroed_proportion
                             / max(1, spec.time_mask_max_frames // 2)))
        starts = randint(T, (B, n_masks))
        widths = randint(spec.time_mask_max_frames + 1, (B, n_masks))
        t_idx = torch.arange(T, device=device)[None, None, :]
        hit = ((t_idx >= starts[:, :, None])
               & (t_idx < (starts + widths)[:, :, None])).any(dim=1)
        t_keep = ~hit
    return f_keep, t_keep


def _grid_base(model: Model, stride: int) -> frozenset:
    order = model.execution_order()
    consumers = _consumers(model)

    def offsets_ok(layer):
        t, s = layer.type, layer.spec
        if t in (LayerType.TDNNF, LayerType.ATTENTION_RELU_BATCHNORM):
            return s.time_stride % stride == 0
        if t == LayerType.CONV_RELU_BATCHNORM:
            return all(o % stride == 0 for o in s.time_offsets)
        return t not in (LayerType.INPUT, LayerType.SPEC_AUGMENT)

    grid = set()
    for layer in reversed(order):
        if not offsets_ok(layer):
            continue
        cons = consumers[layer.name]
        is_out = layer.type == LayerType.OUTPUT
        if (is_out and not cons) or (cons and all(c in grid for c in cons)):
            grid.add(layer.name)
    return frozenset(grid)


def _consumers(model: Model):
    consumers = {l.name: [] for l in model.execution_order()}
    prev = None
    for layer in model.execution_order():
        if layer.type == LayerType.INPUT:
            prev = layer.name
            continue
        ref = layer.input.ref
        names = (list(layer.input.names) if ref.type != InputType.PREVIOUS
                 else [prev])
        for n in names:
            consumers[n].append(layer.name)
        prev = layer.name
    return consumers


def conv_cut_layers(model: Model, stride: int) -> frozenset:
    base = _grid_base(model, stride)
    consumers = _consumers(model)
    cut = set()
    for layer in model.execution_order():
        if layer.type != LayerType.CONV_RELU_BATCHNORM or layer.name in base:
            continue
        cons = consumers[layer.name]
        if _direct_conv_ok(layer.spec) and cons and all(c in base
                                                        for c in cons):
            cut.add(layer.name)
    return frozenset(cut)


def _grid_spec(layer: Layer, stride: int):
    t, s = layer.type, layer.spec
    if t in (LayerType.TDNNF, LayerType.ATTENTION_RELU_BATCHNORM) \
            and s.time_stride:
        return dataclasses.replace(s, time_stride=s.time_stride // stride)
    if t == LayerType.CONV_RELU_BATCHNORM and any(s.time_offsets):
        return dataclasses.replace(
            s, time_offsets=tuple(o // stride for o in s.time_offsets))
    return s


def forward(model: Model, params, state, features, ivectors, *,
            generator=None, time_subsample=None, ng: Optional[NGContext] = None,
            quant: Quant = None):
    """The training forward: ({output: [B, T', dim] fp32}, new BN state).
    time_subsample=(stride, offset, n_grid) runs the grid-eligible layers
    at frames offset + k * stride only (cut convs too, unless ng)."""
    B, T, _ = features.shape
    acts, outputs = {}, {}
    new_state = dict(state)
    grid, cut = frozenset(), frozenset()
    g_stride = 1
    if time_subsample is not None:
        g_stride, g_offset, n_grid = time_subsample
        grid = _grid_base(model, g_stride)
        if ng is None:
            cut = conv_cut_layers(model, g_stride)
            grid = grid | cut

    def to_grid(a):
        return a[:, g_offset:g_offset + (n_grid - 1) * g_stride + 1:g_stride]

    prev = None
    for layer in model.execution_order():
        t = layer.type
        on_grid = layer.name in grid and layer.name not in cut
        s = _grid_spec(layer, g_stride) if on_grid else layer.spec
        if t == LayerType.INPUT:
            if layer.name == "ivector":
                acts[layer.name] = ivectors.float()[:, None, :].expand(
                    B, T, ivectors.shape[-1])
            else:
                acts[layer.name] = features.float()
            prev = layer.name
            continue
        names = ([prev] if layer.input.ref.type == InputType.PREVIOUS
                 else list(layer.input.names))
        parts = [to_grid(acts[n]) if on_grid and n not in grid else acts[n]
                 for n in names]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        p = params.get(layer.name, {})
        st = state.get(layer.name)
        name = layer.name
        if t == LayerType.IDCT:
            out = _mm(x, torch.as_tensor(
                make_idct_matrix(s.dim, s.cepstral_lifter), device=x.device),
                quant)
        elif t == LayerType.LINEAR:
            out = _site(ng, f"{name}/w", x, _mm(x, p["w"], quant))
        elif t == LayerType.BATCHNORM:
            out, new_state[name] = _batchnorm(x, st, s.target_rms, s.epsilon)
        elif t == LayerType.SPEC_AUGMENT:
            out = x
            if generator is not None:
                f_keep, t_keep = spec_augment_masks(s, B, x.shape[1],
                                                    generator, x.device)
                if f_keep is not None:
                    out = out * f_keep[:, None, :].float()
                if t_keep is not None:
                    out = out * t_keep[:, :, None].float()
        elif t == LayerType.COMBINE_FEATURE_MAPS:
            h = s.height
            nfs = [s.num_filters1, s.num_filters2] + (
                [s.num_filters3] if s.num_filters3 else [])
            blocks, off = [], 0
            for nf in nfs:
                blocks.append(x[..., off:off + h * nf].reshape(
                    B, x.shape[1], h, nf))
                off += h * nf
            out = torch.cat(blocks, dim=-1).reshape(B, x.shape[1], -1)
        elif t == LayerType.CONV_RELU_BATCHNORM:
            gc = (g_stride, g_offset, n_grid) if name in cut else None
            out, new_state[name] = _conv(s, p, st, x, quant, ng, name, gc)
        elif t == LayerType.TDNNF:
            out, new_state[name] = _tdnnf(s, p, st, x, quant, ng, name)
        elif t == LayerType.ATTENTION_RELU_BATCHNORM:
            out, new_state[name] = _attention(s, p, st, x, quant, ng, name)
        elif t == LayerType.RELU_BATCHNORM:
            out = _site(ng, f"{name}/w", x, _mm(x, p["w"], quant) + p["b"])
            out, new_state[name] = _batchnorm(torch.relu(out), st,
                                              s.target_rms, 1e-3)
        elif t == LayerType.PREFINAL:
            big = _site(ng, f"{name}/big_w", x,
                        _mm(x, p["big_w"], quant) + p["big_b"])
            big, ns1 = _batchnorm(torch.relu(big), st["bn1"], s.target_rms,
                                  1e-3)
            small = _site(ng, f"{name}/small_w", big,
                          _mm(big, p["small_w"], quant))
            out, ns2 = _batchnorm(small, st["bn2"], s.target_rms, 1e-3)
            new_state[name] = {"bn1": ns1, "bn2": ns2}
        elif t == LayerType.OUTPUT:
            out = _site(ng, f"{name}/w", x, _mm(x, p["w"], quant) + p["b"])
            if s.include_log_softmax:
                out = torch.log_softmax(out, dim=-1)
            outputs[name] = out
        else:
            out = x
        acts[name] = out
        prev = name
    return outputs, new_state


def grid_layers(model: Model, stride: int) -> frozenset:
    return _grid_base(model, stride) if stride > 1 else frozenset()
