"""The xconfig network on PyTorch: fp32 master weights, bf16 compute.

Port of kaldi_fp16_tpu/models/network.py for the flagship layer set:
idct, batchnorm, SpecAugment, the ivector linear (ReplaceIndex input),
combine-feature-maps, conv-relu-batchnorm (direct, cut-conv and patch
lowerings), tdnnf, restricted attention (attention-relu-batchnorm),
relu-batchnorm, prefinal and the output heads, and the natural-gradient
sites (`ng_sites`, `NGContext`): every layer type the JAX package builds.

Layouts follow the JAX package at every public boundary: activations are
[B, T, D] with a feature map's column = height * num_filters + filter
(filter fastest), and matmul weights are [in, out].  Only the conv
weights differ: the JAX package stores them HWIO-flattened
[kt * kh * nf_in, nf_out]; here they are OIHW [nf_out, nf_in, kt, kh], as
F.conv2d takes them (convert.py maps between the two).

BatchNorm follows Kaldi BatchNormComponent: batch statistics over
(batch, time) in fp32 while training, a Chan merge into the running
statistics, target-rms scaling, no learnable scale or offset.  `forward`
does not write the running statistics: it returns them, and the caller
commits them with `set_bn_state` (the train step keeps the old ones on a
skipped, non-finite batch).  Under a data group (`forward(group=...)`,
parallel/mesh.py) each rank holds its rows of the batch, and BatchNorm
takes its statistics over every rank's rows (parallel/data_parallel.py
`batch_moments`), as the JAX package's sharded step does.  Under a mesh
with a seq axis each rank holds its frames too: every temporal op (the
splices, the conv's time offsets, attention's context, the frame grid and
the cut conv's window) reads its neighbours' edge frames through a halo
exchange (`TimeChunks.halo`), and the outputs are gathered along time
before they are returned.  Under a model axis the TDNN-F affines, the
prefinal layers and the output heads hold their columns
(`param_shardings`): column-parallel matmuls whose outputs are gathered
before relu / BatchNorm / log_softmax, and the prefinal small_w
row-parallel on the rank's columns of the normalised big output.

Natural gradient (NG-SGD): with an `NGContext`, the forward records each
site's matmul input X and registers a hook on the site's fp32
pre-activation output, whose gradient is the output derivative G that
the JAX package takes as the gradient of a zero tap added at the same
point (network.py:278-302 there).  As there, the convs then use the
patch lowering (X is the materialised patch) and no conv is cut.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.models.layers import (
    AttentionSpec, CombineFeatureMapsSpec, ConvReluBNSpec, Layer,
    SpecAugmentSpec, TDNNFSpec,
)
from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.xconfig import InputType, LayerType
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    TimeChunks, batch_moments, copy_to, gather_cols, reduce_from, spec_rows,
)
from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes

Params = Dict[str, Dict[str, torch.Tensor]]
State = Dict[str, dict]


# ---------------------------------------------------------------------------
# Fixed matrices and parameter layouts
# ---------------------------------------------------------------------------

def make_idct_matrix(dim: int, cepstral_lifter: float) -> np.ndarray:
    """IDCT matrix used as x @ M ([in=cepstra, out=mel] orientation), with
    the cepstral lifter divided out on the contraction index (network.py
    of the JAX package documents the two bugs this shape avoids)."""
    mat = np.zeros((dim, dim), dtype=np.float64)
    for i in range(dim):          # cepstral (contraction) index
        lc = 1.0
        if cepstral_lifter > 0 and i > 0:
            lc = 1.0 + (cepstral_lifter / 2.0) * math.sin(
                math.pi * i / cepstral_lifter)
        norm = math.sqrt((1.0 if i == 0 else 2.0) / dim)
        for j in range(dim):      # output mel-bin index
            mat[i, j] = norm * math.cos(math.pi * i * (j + 0.5) / dim) / lc
    return mat.astype(np.float32)


def conv_weight_to_oihw(w: torch.Tensor, spec: ConvReluBNSpec) -> torch.Tensor:
    """JAX layout [kt*kh*nf_in, nf_out] (HWIO, time-major offsets) ->
    [nf_out, nf_in, kt, kh]."""
    kt, kh = len(spec.time_offsets), len(spec.height_offsets)
    return (w.reshape(kt, kh, spec.num_filters_in, spec.num_filters_out)
            .permute(3, 2, 0, 1).contiguous())


def conv_weight_from_oihw(w: torch.Tensor, spec: ConvReluBNSpec) -> torch.Tensor:
    """Inverse of conv_weight_to_oihw."""
    return w.permute(2, 3, 1, 0).reshape(-1, spec.num_filters_out)


def _bn_dims(layer: Layer) -> Dict[str, int]:
    """BatchNorm state slots of a layer: name -> dim (the JAX state tree)."""
    s, t = layer.spec, layer.type
    if t == LayerType.BATCHNORM:
        return {"bn": s.dim}
    if t in (LayerType.CONV_RELU_BATCHNORM, LayerType.TDNNF,
             LayerType.RELU_BATCHNORM, LayerType.ATTENTION_RELU_BATCHNORM):
        return {"bn": s.output_dim}
    if t == LayerType.PREFINAL:
        return {"bn1": s.big_dim, "bn2": s.small_dim}
    return {}


def _init_layer(layer: Layer, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """fp32 parameters of one layer in the port's layout: Xavier-normal
    weights, zero biases, the fixed IDCT matrix (network.py:103-144)."""
    s, t = layer.spec, layer.type

    def xavier(fan_in, fan_out):
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    if t == LayerType.IDCT:
        return {"idct": torch.as_tensor(
            make_idct_matrix(s.dim, s.cepstral_lifter), device=device)}
    if t == LayerType.LINEAR:
        return {"w": xavier(s.input_dim, s.output_dim)}
    if t == LayerType.CONV_RELU_BATCHNORM:
        k = len(s.offsets) * s.num_filters_in
        return {"w": conv_weight_to_oihw(xavier(k, s.num_filters_out), s),
                "b": zeros(s.num_filters_out)}
    if t == LayerType.TDNNF:
        m = 2 if s.time_stride > 0 else 1
        return {"linear_w": xavier(s.input_dim * m, s.bottleneck_dim),
                "affine_w": xavier(s.bottleneck_dim * m, s.output_dim),
                "affine_b": zeros(s.output_dim)}
    if t == LayerType.RELU_BATCHNORM:
        return {"w": xavier(s.input_dim, s.output_dim),
                "b": zeros(s.output_dim)}
    if t == LayerType.PREFINAL:
        return {"big_w": xavier(s.input_dim, s.big_dim),
                "big_b": zeros(s.big_dim),
                "small_w": xavier(s.big_dim, s.small_dim)}
    if t == LayerType.OUTPUT:
        return {"w": xavier(s.input_dim, s.output_dim),
                "b": zeros(s.output_dim)}
    if t == LayerType.ATTENTION_RELU_BATCHNORM:
        proj = s.num_heads * s.input_dim_per_head
        return {"w": xavier(s.input_dim, proj), "b": zeros(proj)}
    return {}


def trainable_mask(model: Model, params: Params) -> Dict[str, Dict[str, bool]]:
    """False for fixed matrices (idct), True for everything else."""
    mask = {}
    for lname, p in params.items():
        layer = model.layer_map.get(lname)
        fixed = layer is not None and layer.type == LayerType.IDCT
        mask[lname] = {k: not fixed for k in p}
    return mask


# ---------------------------------------------------------------------------
# Primitive blocks
# ---------------------------------------------------------------------------

def _matmul(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w with both operands in the compute dtype; fp32 result."""
    return torch.matmul(x.to(dtype), w.to(dtype)).float()


def _batchnorm(x: torch.Tensor, st: dict, target_rms: float, epsilon: float,
               train: bool, tc: Optional[TimeChunks] = None
               ) -> Tuple[torch.Tensor, dict]:
    """Kaldi BatchNormComponent: stats over (batch, time), target-rms scale.
    Returns (normalised x in x.dtype, new running statistics).  Under a
    mesh (tc: the frame rate's chunks, parallel/data_parallel.py) the
    statistics, and the running ones, are those of every rank's rows and
    frames."""
    xf = x.float()
    if train:
        if tc is None or tc.dp is None:
            mean = xf.mean(dim=(0, 1))
            var = torch.clamp(xf.var(dim=(0, 1), unbiased=False), min=0.0)
            n = float(x.shape[0] * x.shape[1])
        else:
            mean, var, n = batch_moments(
                xf, tc.dp, tc.total(x.shape[0] * x.shape[1]))
        with torch.no_grad():
            old_n = st["count"]
            count = old_n + n
            delta = mean.detach() - st["mean"]
            new_mean = st["mean"] + delta * (n / count)
            # parallel-variance (Chan) merge: keeps the running var equal to
            # E[x^2] - E[x]^2 over all frames seen, as Kaldi's sums do
            new_var = (old_n * st["var"] + n * var.detach()
                       + delta * delta * old_n * n / count) / count
        new_state = {"count": count, "mean": new_mean, "var": new_var}
    else:
        mean, var = st["mean"], st["var"]
        new_state = st
    scale = target_rms * torch.rsqrt(var + epsilon)
    return ((xf - mean) * scale).to(x.dtype), new_state


def _shift_time(x: torch.Tensor, offset: int, mode: str) -> torch.Tensor:
    """x[:, t] := x[:, t + offset]; out of range per mode ('zero'|'clamp')."""
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


def _shifted(x: torch.Tensor, offsets, mode: str,
             tc: Optional[TimeChunks] = None) -> list:
    """x shifted by each offset (_shift_time).  Under a seq axis x is this
    rank's chunk: one halo exchange brings the neighbours' frames the
    shifts read, and `mode` fills only the sequence's ends."""
    if tc is None or tc.seq is None:
        return [_shift_time(x, o, mode) for o in offsets]
    left, right = max(0, -min(offsets)), max(0, max(offsets))
    ext = tc.halo(x, left, right, mode)
    n = x.shape[1]
    return [ext[:, left + o:left + o + n] for o in offsets]


def _splice(x: torch.Tensor, offsets, mode: str,
            tc: Optional[TimeChunks] = None) -> torch.Tensor:
    """Concat time-shifted copies along the feature axis."""
    return torch.cat(_shifted(x, offsets, mode, tc), dim=-1)


def _even_spacing(offsets) -> Optional[int]:
    """Common difference of an ascending arithmetic offset sequence, or
    None if irregular (single offset -> 1)."""
    if len(offsets) == 1:
        return 1
    d = offsets[1] - offsets[0]
    if d <= 0 or any(offsets[i + 1] - offsets[i] != d
                     for i in range(len(offsets) - 1)):
        return None
    return d


def _direct_conv_ok(spec: ConvReluBNSpec) -> bool:
    return (_even_spacing(spec.time_offsets) is not None
            and _even_spacing(spec.height_offsets) is not None
            and min(spec.time_offsets) <= 0
            and min(spec.height_offsets) <= 0 <= max(spec.height_offsets))


# ---------------------------------------------------------------------------
# Natural-gradient sites
# ---------------------------------------------------------------------------

class NGContext:
    """Collects, per natural-gradient site ("<layer>/<param>"), the matmul
    input X (`xs`) and, once the backward has run, the gradient G of the
    site's fp32 pre-activation output (`gs`).  Once `frozen`, sites record
    nothing: a rematerialised forward (TrainConfig.remat) re-runs them
    during the backward, and must neither replace X nor hook a second
    output."""

    def __init__(self):
        self.xs: Dict[str, torch.Tensor] = {}
        self.gs: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}
        self.frozen = False

    def site(self, name: str, x: torch.Tensor, out: torch.Tensor,
             count: Optional[int] = None) -> torch.Tensor:
        """count: every rank's samples of the site, when the forward runs
        on a share of the batch (`fisher_update`'s N)."""
        if self.frozen:
            return out
        self.xs[name] = x.detach()
        if count is not None:
            self.counts[name] = count
        if out.requires_grad:
            out.register_hook(lambda g, name=name: self.gs.__setitem__(name, g))
        return out


def _site(ng: Optional[NGContext], name: str, x, out,
          tc: Optional[TimeChunks] = None):
    if ng is None:
        return out
    return ng.site(name, x, out,
                   None if tc is None else tc.total(x[..., 0].numel()))


def ng_sites(model: Model):
    """Registry of natural-gradient sites for a model: one per matmul
    application, with the param names and dims needed to precondition the
    accumulated gradient (copied from network.py:838-884 of the JAX
    package; `in_dim` counts rows of the JAX weight layout)."""
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
                              b=None, in_dim=sp.big_dim, out_dim=sp.small_dim))
        elif t == LayerType.OUTPUT:
            sites.append(dict(name=f"{n}/w", layer=n, w="w", b="b",
                              in_dim=sp.input_dim, out_dim=sp.output_dim))
    return sites


# ---------------------------------------------------------------------------
# Layer forwards
# ---------------------------------------------------------------------------

def _fwd_conv_relu_bn(spec: ConvReluBNSpec, p: dict, bn: dict,
                      x: torch.Tensor, train: bool, dtype, ng=None, lname="",
                      grid_cut=None, tc=None, tc_out=None
                      ) -> Tuple[torch.Tensor, dict]:
    """Convolution over (time, height).  x: [B, T, H_in * nf_in], filter
    fastest.  Two lowerings, the same math (network.py:321-426):

      * direct: one F.conv2d, dilation encoding evenly spaced offsets,
        stride the height subsample.  F.conv2d pads symmetrically, so the
        asymmetric padding is applied explicitly first.
        grid_cut=(stride, offset, n_grid) is the cut conv: full-rate input,
        output only at frames offset + j*stride, via a time-strided window;
        equal to the full-rate conv at those frames (same zero padding).
      * patch: time shifts, height slices and one concat into the patch
        [B, T, H_out, k * nf_in] (offsets time-major, height fastest, the
        JAX weight layout's row order), then one matmul.  It serves
        irregular offset grids and NG-SGD, whose input Fisher factor taps
        the patch.

    tc: the input's chunks (the time offsets read a halo under seq);
    tc_out: the output's (the grid's for a cut conv; default tc)."""
    tc_out = tc if tc_out is None else tc_out
    B, T, _ = x.shape
    H_in, H_out = spec.height_in, spec.height_out
    nf_in, nf_out = spec.num_filters_in, spec.num_filters_out
    sub = spec.height_subsample
    h_offs, t_offs = spec.height_offsets, spec.time_offsets
    pad_lo = max(0, -min(h_offs))
    pad_hi = max(0, (H_out - 1) * sub + max(h_offs) - (H_in - 1))
    if ng is not None or not _direct_conv_ok(spec):
        if grid_cut is not None:
            raise ValueError("a cut conv needs the direct lowering")
        patches = []
        for xt in _shifted(x, t_offs, "zero", tc):
            xt = xt.reshape(B, T, H_in, nf_in)
            if pad_lo or pad_hi:
                xt = F.pad(xt, (0, 0, pad_lo, pad_hi))
            for h_off in h_offs:
                start = pad_lo + h_off
                patches.append(xt[:, :, start:start + (H_out - 1) * sub + 1:sub])
        patch = torch.cat(patches, dim=-1)        # [B, T, H_out, k * nf_in]
        out = (_matmul(patch, conv_weight_from_oihw(p["w"], spec), dtype)
               + p["b"].float())
        out = _site(ng, f"{lname}/w", patch, out, tc)
        out = torch.relu(out).reshape(B, T, H_out * nf_out).to(dtype)
        return _batchnorm(out, bn, spec.target_rms, 1e-3, train, tc_out)
    t_lo, t_hi = -min(t_offs), max(t_offs)
    dilation = (_even_spacing(t_offs), _even_spacing(h_offs))

    if tc is not None and tc.seq is not None:
        xs = tc.halo(x, t_lo, t_hi, "zero")
        xs = xs.reshape(B, -1, H_in, nf_in).to(dtype).permute(0, 3, 1, 2)
        xpad = F.pad(xs, (pad_lo, pad_hi, 0, 0))
    else:
        xs = x.reshape(B, T, H_in, nf_in).to(dtype).permute(0, 3, 1, 2)
        xpad = F.pad(xs, (pad_lo, pad_hi, t_lo, t_hi))            # NCHW
    w = p["w"].to(dtype)
    if grid_cut is not None:
        g_stride, g_offset, n_grid = grid_cut
        need = (n_grid - 1) * g_stride + (t_hi + t_lo + 1)
        out = F.conv2d(xpad[:, :, g_offset:g_offset + need], w,
                       stride=(g_stride, sub), dilation=dilation)
        T = n_grid
    else:
        out = F.conv2d(xpad, w, stride=(1, sub), dilation=dilation)
    out = out[:, :, :T, :H_out].float() + p["b"].float()[None, :, None, None]
    out = torch.relu(out).permute(0, 2, 3, 1)          # [B, T, H_out, nf_out]
    out = out.reshape(B, T, H_out * nf_out).to(dtype)  # filter fastest
    return _batchnorm(out, bn, spec.target_rms, 1e-3, train, tc_out)


def _fwd_tdnnf(spec: TDNNFSpec, p: dict, bn: dict, x: torch.Tensor,
               train: bool, dtype, ng=None, lname="", tc=None,
               tp=None) -> Tuple[torch.Tensor, dict]:
    """splice[-s,0] -> linear -> splice[0,+s] -> affine -> relu -> bn ->
    bypass (clamped edges).  tp (the model axis's group): the affine holds
    its columns; the output is gathered before relu / BatchNorm."""
    s = spec.time_stride
    lin_in = _splice(x, (-s, 0), "clamp", tc) if s > 0 else x
    bottleneck = _matmul(lin_in, p["linear_w"], dtype)
    bottleneck = _site(ng, f"{lname}/linear_w", lin_in, bottleneck,
                       tc).to(dtype)
    aff_in = _splice(bottleneck, (0, s), "clamp", tc) if s > 0 else bottleneck
    if tp is None:
        out = _matmul(aff_in, p["affine_w"], dtype) + p["affine_b"].float()
        out = _site(ng, f"{lname}/affine_w", aff_in, out, tc)
    else:
        out = (_matmul(copy_to(aff_in, tp), p["affine_w"], dtype)
               + p["affine_b"].float())
        out = gather_cols(_site(ng, f"{lname}/affine_w", aff_in, out, tc), tp)
    out = torch.relu(out).to(dtype)
    out, new_bn = _batchnorm(out, bn, spec.target_rms, 1e-3, train, tc)
    if spec.bypass_scale > 0 and spec.input_dim == spec.output_dim:
        # the scale is rounded to the compute dtype first, as in JAX
        out = out + x.new_tensor(spec.bypass_scale, dtype=out.dtype) * x
    return out, new_bn


def _fwd_attention(spec: AttentionSpec, p: dict, bn: dict, x: torch.Tensor,
                   train: bool, dtype, ng=None, lname="",
                   tc=None) -> Tuple[torch.Tensor, dict]:
    """Restricted per-head time attention (network.py:447-482): one
    projection into keys, values, query-keys and query-context scores per
    head; for each of the context_dim offsets o, the keys and values at
    t + (o - num_left_inputs) * time_stride (zero outside), scored in
    fp32; softmax over the offsets, the weighted values and the weights
    concatenated per head, relu, BatchNorm."""
    B, T, _ = x.shape
    H, kd, vd = spec.num_heads, spec.key_dim, spec.value_dim
    cd = spec.context_dim
    proj = _matmul(x, p["w"], dtype) + p["b"].float()      # [B, T, H * iph]
    proj = _site(ng, f"{lname}/w", x, proj, tc)
    proj = proj.reshape(B, T, H, spec.input_dim_per_head)
    keys = proj[..., :kd]
    values = proj[..., kd:kd + vd]
    q_key = proj[..., kd + vd:kd + vd + kd]
    q_ctx = proj[..., kd + vd + kd:]
    deltas = [(o - spec.num_left_inputs) * spec.time_stride
              for o in range(cd)]
    scores = []
    vals = _shifted(values, deltas, "zero", tc)
    for o, k in enumerate(_shifted(keys, deltas, "zero", tc)):
        dot = (q_key * k).sum(-1)
        scores.append(q_ctx[..., o] + spec.key_scale * dot)   # [B, T, H]
    attn = torch.softmax(torch.stack(scores, dim=-1), dim=-1)  # [B, T, H, cd]
    ctx_out = torch.einsum("bthc,bthcv->bthv", attn,
                           torch.stack(vals, dim=-2))
    out = torch.cat([ctx_out, attn], dim=-1).reshape(B, T, H * (vd + cd))
    out = torch.relu(out).to(dtype)
    return _batchnorm(out, bn, spec.target_rms, 1e-3, train, tc)


def spec_augment_masks(spec: SpecAugmentSpec, B: int, T: int,
                       generator: torch.Generator, device=None):
    """Draw SpecAugment keep-masks: (freq_keep [B, D] bool or None,
    time_keep [B, T] bool or None).  Same distributions as the JAX
    package (network.py:485-509): one frequency band of width uniform in
    [0, freq_max_proportion * D], and time masks covering about
    time_zeroed_proportion of the frames."""
    D = spec.dim
    device = resolve_device(device)
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


def _draw_masks(spec: SpecAugmentSpec, B: int, T: int,
                generator: torch.Generator, device, group=None):
    """One SpecAugment layer's masks as the forward draws them: for the
    global batch under a mesh, of which this rank keeps its rows and (seq
    axis) its frames."""
    if group is None:
        return spec_augment_masks(spec, B, T, generator, device)
    tc = TimeChunks.even(T, group)
    masks = spec_augment_masks(spec, B * tc.data, tc.T, generator, device)
    return spec_rows(masks, group, tc if tc.seq is not None else None)


def draw_spec_masks(model: Model, B: int, T: int,
                    generator: torch.Generator, device=None,
                    group=None) -> dict:
    """{layer: masks} of every SpecAugment layer, drawn from `generator` in
    the order and with the shapes the forward draws them (SpecAugment runs
    at the input's frame rate, T frames), so that `forward(spec_masks=...)`
    equals `forward(generator=...)` and leaves the generator in the same
    state."""
    device = resolve_device(device)
    return {layer.name: _draw_masks(layer.spec, B, T, generator, device,
                                    group)
            for layer in model.execution_order()
            if layer.type == LayerType.SPEC_AUGMENT}


def _fwd_spec_augment(x: torch.Tensor, masks) -> torch.Tensor:
    f_keep, t_keep = masks
    if f_keep is not None:
        x = x * f_keep[:, None, :].to(x.dtype)
    if t_keep is not None:
        x = x * t_keep[:, :, None].to(x.dtype)
    return x


def _fwd_combine_feature_maps(spec: CombineFeatureMapsSpec,
                              x: torch.Tensor) -> torch.Tensor:
    """Interleave blocked feature maps into the h*(nf1+nf2[+nf3]) + f layout."""
    B, T, D = x.shape
    h = spec.height
    nfs = [spec.num_filters1, spec.num_filters2]
    if spec.num_filters3:
        nfs.append(spec.num_filters3)
    blocks = []
    off = 0
    for nf in nfs:
        blocks.append(x[..., off:off + h * nf].reshape(B, T, h, nf))
        off += h * nf
    return torch.cat(blocks, dim=-1).reshape(B, T, D)


# ---------------------------------------------------------------------------
# Time-grid analysis (the nnet3 computation-compiler equivalent); pure
# Python, copied from the JAX package's network.py:533-656
# ---------------------------------------------------------------------------

def grid_layers(model: Model, stride: int, conv_cut: bool = False) -> frozenset:
    """Layers that can run on the stride-`stride` time grid: their time
    offsets are multiples of the stride and every consumer is on the grid
    (output layers seed the set).  conv_cut=True adds the cut convs."""
    if stride <= 1:
        return frozenset()
    base = _grid_base(model, stride)
    if not conv_cut:
        return base
    return base | conv_cut_layers(model, stride)


def _grid_base(model: Model, stride: int) -> frozenset:
    order = model.execution_order()
    consumers = _consumers(model)

    def offsets_ok(layer: Layer) -> bool:
        t, s = layer.type, layer.spec
        if t == LayerType.TDNNF:
            return s.time_stride % stride == 0
        if t == LayerType.ATTENTION_RELU_BATCHNORM:
            return s.time_stride % stride == 0
        if t == LayerType.CONV_RELU_BATCHNORM:
            return all(o % stride == 0 for o in s.time_offsets)
        if t in (LayerType.INPUT, LayerType.SPEC_AUGMENT):
            return False
        return True     # pointwise: idct/linear/bn/combine/prefinal/output

    grid = set()
    for layer in reversed(order):
        if not offsets_ok(layer):
            continue
        cons = consumers[layer.name]
        is_out = layer.type == LayerType.OUTPUT
        if (is_out and not cons) or (cons and all(c in grid for c in cons)):
            grid.add(layer.name)
    return frozenset(grid)


def _consumers(model: Model) -> Dict[str, list]:
    order = model.execution_order()
    consumers: Dict[str, list] = {l.name: [] for l in order}
    prev = None
    for layer in order:
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
    """Convs at the full->grid boundary that emit grid frames through a
    time-strided window over their full-rate input (no cascade)."""
    if stride <= 1:
        return frozenset()
    base = _grid_base(model, stride)
    consumers = _consumers(model)
    cut = set()
    for layer in model.execution_order():
        if layer.type != LayerType.CONV_RELU_BATCHNORM:
            continue
        if layer.name in base:
            continue                     # already grid via divisible offsets
        cons = consumers[layer.name]
        if _direct_conv_ok(layer.spec) and cons and all(c in base for c in cons):
            cut.add(layer.name)
    return frozenset(cut)


def _grid_spec(layer: Layer, stride: int):
    """Layer spec with time offsets rescaled to grid steps."""
    t, s = layer.type, layer.spec
    if t in (LayerType.TDNNF, LayerType.ATTENTION_RELU_BATCHNORM) \
            and s.time_stride:
        return dataclasses.replace(s, time_stride=s.time_stride // stride)
    if t == LayerType.CONV_RELU_BATCHNORM and any(s.time_offsets):
        return dataclasses.replace(
            s, time_offsets=tuple(o // stride for o in s.time_offsets))
    return s


# ---------------------------------------------------------------------------
# The network module
# ---------------------------------------------------------------------------

class _BNState(nn.Module):
    """Running BatchNorm statistics of one normalisation (buffers)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("count", torch.zeros((), device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))

    def as_dict(self) -> dict:
        return {"count": self.count, "mean": self.mean, "var": self.var}


class _LayerState(nn.Module):
    """One xconfig layer's fp32 master parameters and BN statistics."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 bn_dims: Dict[str, int], device=None):
        super().__init__()
        device = resolve_device(device)
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))
        for name, dim in bn_dims.items():
            self.add_module(name, _BNState(dim, device))


def module_key(layer_name: str) -> str:
    """nn.Module names may not hold '.', which Kaldi layer names may."""
    return layer_name.replace(".", "_")


class Network(nn.Module):
    """A Model's parameters (fp32 masters) and BN statistics, with the
    forward pass.  `params` and `bn_state()` mirror the JAX package's
    parameter and state trees ({layer: {name: tensor}})."""

    def __init__(self, model: Model, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.model = model
        self.layers = nn.ModuleDict()
        self._keys: Dict[str, str] = {}
        for layer in model.execution_order():
            params = _init_layer(layer, generator, device)
            bn_dims = _bn_dims(layer)
            if not params and not bn_dims:
                continue
            key = module_key(layer.name)
            if key in self.layers:
                raise ValueError(f"layer names collide as module key {key!r}")
            self._keys[layer.name] = key
            self.layers[key] = _LayerState(params, bn_dims, device)

    @property
    def params(self) -> Dict[str, Dict[str, nn.Parameter]]:
        out = {}
        for lname, key in self._keys.items():
            p = dict(self.layers[key].named_parameters(recurse=False))
            if p:
                out[lname] = p
        return out

    def bn_state(self) -> State:
        out: State = {}
        for lname, key in self._keys.items():
            mod = self.layers[key]
            if hasattr(mod, "bn"):
                out[lname] = mod.bn.as_dict()
            elif hasattr(mod, "bn1"):
                out[lname] = {"bn1": mod.bn1.as_dict(),
                              "bn2": mod.bn2.as_dict()}
        return out

    @torch.no_grad()
    def set_bn_state(self, state: State) -> None:
        """Commit running statistics returned by `forward`."""
        for lname, st in state.items():
            mod = self.layers[self._keys[lname]]
            slots = ({"bn": st} if "count" in st else st)
            for slot, vals in slots.items():
                bn = getattr(mod, slot)
                for name, v in vals.items():
                    getattr(bn, name).copy_(v)

    def forward(self, features: torch.Tensor,
                ivectors: Optional[torch.Tensor] = None, *,
                train: bool = False, compute_dtype=torch.bfloat16,
                time_subsample: Optional[tuple] = None,
                spec_masks: Optional[dict] = None,
                generator: Optional[torch.Generator] = None,
                ng: Optional[NGContext] = None, group=None):
        """Run the network: ({output_name: [B, T, dim] fp32}, new BN state).

        time_subsample=(stride, offset, n_grid) runs every grid-eligible
        layer only at frames offset + k*stride, k < n_grid (the nnet3
        computation-compiler frame rate; network.py:690-701 of the JAX
        package); grid outputs come back with n_grid frames.

        SpecAugment runs only when training, with the masks of
        `spec_masks[layer_name]` ((freq_keep, time_keep), from
        `spec_augment_masks`) if given, else masks drawn from `generator`;
        with neither it is the identity, as in JAX with rng=None.

        ng (an NGContext) collects the natural-gradient sites' inputs and
        output gradients; the convs then take the patch lowering and none
        is cut, as in the JAX package.

        group (a DataGroup or Mesh, parallel/mesh.py): the batch is this
        rank's rows of the global batch (and, under a seq axis, its
        frames: n_grid in time_subsample stays the sequence's); BatchNorm
        takes its statistics over every rank's rows and frames, masks
        drawn from `generator` are drawn for the global batch, of which
        this rank keeps its share, and the outputs come back with every
        frame.  Under a model axis the network holds its columns of the
        sharded layers (parallel/data_parallel.py `shard_train_state`).
        """
        model = self.model
        params = self.params
        state = self.bn_state()
        B, T, _ = features.shape
        dtype = compute_dtype
        acts: Dict[str, torch.Tensor] = {}
        new_state: State = dict(state)
        outputs: Dict[str, torch.Tensor] = {}
        tp = mesh_axes(group).model
        full_tc = None if group is None else TimeChunks.even(T, group)
        grid_tc = None

        grid: frozenset = frozenset()
        cut: frozenset = frozenset()
        g_stride = 1
        if time_subsample is not None:
            g_stride, g_offset, n_grid = time_subsample
            grid = grid_layers(model, g_stride)
            # cut convs need the direct lowering, which NG disables
            if ng is None:
                cut = conv_cut_layers(model, g_stride)
                grid = grid | cut
            # this rank's grid frames: those in its own chunk (all of them
            # without a seq axis), from full-rate frame p0 on
            k_lo, n_k, lo = 0, n_grid, 0
            if full_tc is not None:
                grid_tc = full_tc.grid(g_stride, g_offset, n_grid)
                k_lo, n_k, lo = grid_tc.lo, grid_tc.n, full_tc.lo
            p0 = g_offset + k_lo * g_stride - lo

        def to_grid(a):
            """Full-rate [B, T, ...] -> grid [B, n_grid, ...]."""
            return a[:, p0:p0 + (n_k - 1) * g_stride + 1:g_stride]

        def get_input(layer: Layer, prev_name: Optional[str]) -> torch.Tensor:
            # cut convs consume full-rate input (the stride lives in their
            # convolution window)
            on_grid = layer.name in grid and layer.name not in cut
            if layer.input.ref.type == InputType.PREVIOUS:
                names = [prev_name]
            else:
                names = list(layer.input.names)
            parts = []
            for n in names:
                a = acts[n]
                if on_grid and n not in grid:
                    a = to_grid(a)          # the full->grid cut
                parts.append(a)
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

        prev_name: Optional[str] = None
        for layer in model.execution_order():
            t = layer.type
            s = (_grid_spec(layer, g_stride)
                 if layer.name in grid and layer.name not in cut
                 else layer.spec)
            if t == LayerType.INPUT:
                if layer.name == "ivector":
                    if ivectors is None:
                        raise ValueError("model requires ivectors")
                    iv = ivectors.to(dtype)
                    acts[layer.name] = iv[:, None, :].expand(B, T, iv.shape[-1])
                else:
                    acts[layer.name] = features.to(dtype)
                prev_name = layer.name
                continue

            x = get_input(layer, prev_name)
            p = params.get(layer.name, {})
            st = state.get(layer.name)
            tc = (grid_tc if layer.name in grid and layer.name not in cut
                  else full_tc)

            if t == LayerType.IDCT:
                out = _matmul(x, p["idct"], dtype)
            elif t == LayerType.LINEAR:
                out = _site(ng, f"{layer.name}/w", x,
                            _matmul(x, p["w"], dtype), tc)
            elif t == LayerType.BATCHNORM:
                out, new_state[layer.name] = _batchnorm(
                    x, st, s.target_rms, s.epsilon, train, tc)
            elif t == LayerType.SPEC_AUGMENT:
                masks = None
                if train and spec_masks is not None and layer.name in spec_masks:
                    masks = spec_masks[layer.name]
                elif train and generator is not None:
                    masks = _draw_masks(s, B, x.shape[1], generator,
                                        x.device, group)
                out = x if masks is None else _fwd_spec_augment(x, masks)
            elif t == LayerType.COMBINE_FEATURE_MAPS:
                out = _fwd_combine_feature_maps(s, x)
            elif t == LayerType.CONV_RELU_BATCHNORM:
                gc = (g_stride, p0, n_k) if layer.name in cut else None
                out, new_state[layer.name] = _fwd_conv_relu_bn(
                    s, p, st, x, train, dtype, ng=ng, lname=layer.name,
                    grid_cut=gc, tc=tc, tc_out=grid_tc if gc else tc)
            elif t == LayerType.TDNNF:
                out, new_state[layer.name] = _fwd_tdnnf(
                    s, p, st, x, train, dtype, ng=ng, lname=layer.name,
                    tc=tc, tp=tp)
            elif t == LayerType.ATTENTION_RELU_BATCHNORM:
                out, new_state[layer.name] = _fwd_attention(
                    s, p, st, x, train, dtype, ng=ng, lname=layer.name,
                    tc=tc)
            elif t == LayerType.RELU_BATCHNORM:
                out = _matmul(x, p["w"], dtype) + p["b"].float()
                out = _site(ng, f"{layer.name}/w", x, out, tc)
                out = torch.relu(out).to(dtype)
                out, new_state[layer.name] = _batchnorm(
                    out, st, s.target_rms, 1e-3, train, tc)
            elif t == LayerType.PREFINAL:
                xin = x if tp is None else copy_to(x, tp)
                big = _matmul(xin, p["big_w"], dtype) + p["big_b"].float()
                big = _site(ng, f"{layer.name}/big_w", x, big, tc)
                if tp is not None:
                    big = gather_cols(big, tp)
                big = torch.relu(big).to(dtype)
                big, ns1 = _batchnorm(big, st["bn1"], s.target_rms, 1e-3,
                                      train, tc)
                if tp is None:
                    small = _matmul(big, p["small_w"], dtype)
                else:
                    # row-parallel: this rank's columns of the whole,
                    # normalised big output against its rows of small_w.
                    # The partial products are summed in fp32 and rounded
                    # to the compute dtype once, as one matmul's output is
                    # (products of bf16 values are exact in fp32)
                    w = big.shape[-1] // tp.world
                    part = torch.matmul(
                        big[..., tp.rank * w:(tp.rank + 1) * w].to(
                            dtype).float(), p["small_w"].to(dtype).float())
                    small = reduce_from(part, tp).to(dtype).float()
                small = _site(ng, f"{layer.name}/small_w", big, small,
                              tc).to(dtype)
                out, ns2 = _batchnorm(small, st["bn2"], s.target_rms, 1e-3,
                                      train, tc)
                new_state[layer.name] = {"bn1": ns1, "bn2": ns2}
            elif t == LayerType.OUTPUT:
                xin = x if tp is None else copy_to(x, tp)
                out = _matmul(xin, p["w"], dtype) + p["b"].float()
                out = _site(ng, f"{layer.name}/w", x, out, tc)
                if tp is not None:
                    out = gather_cols(out, tp)
                if s.include_log_softmax:
                    out = torch.log_softmax(out, dim=-1)
                if tc is not None and tc.seq is not None:
                    out = tc.gather(out)
                outputs[layer.name] = out   # outputs stay fp32
            else:                           # no-op-component
                out = x

            acts[layer.name] = out if t == LayerType.OUTPUT else out.to(dtype)
            prev_name = layer.name

        return outputs, new_state


def subsample_output(x: torch.Tensor, stride: int, offset: int,
                     num_frames: int) -> torch.Tensor:
    """Pick chain-supervision frames: rows offset, offset+stride, ...
    of [B, T, ...] (kaldi_fp16_tpu/models/network.py:904)."""
    return x[:, offset:offset + (num_frames - 1) * stride + 1:stride]
