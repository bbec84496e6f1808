"""SGD with momentum, fp32 master weights and Kaldi max-change, on PyTorch.

Port of kaldi_fp16_tpu/training/optimizer.py (`SGDConfig` :33,
`layer_hyperparams` :40, `sgd_update` :70-154).  Max-change follows Kaldi
nnet3 (nnet-utils.cc):
  * per component: scale the layer's delta so ||lr*v|| <= max_change_i;
  * global: scale all deltas so sqrt(sum_i ||delta_i||^2) <= max_param_change.
L2 (xconfig l2-regularize) is learning-rate-scaled weight decay applied
outside the clipped delta (Kaldi ApplyL2Regularization).  Parameters,
gradients and velocities are nested dicts {layer: {name: tensor}}.

Under a mesh's model axis a layer may mix replicated leaves (a TDNN-F
layer's linear_w) with leaves of which each rank holds a slice
(affine_w): the norms then add the sharded leaves' squares over the
model ranks (one all-reduce), so every rank scales its replicated leaves
by the same factor and they stay bit-identical across the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from kaldi_fp16_tpu_torch.models.layers import ConvReluBNSpec, OutputSpec
from kaldi_fp16_tpu_torch.models.model import Model


@dataclass(frozen=True)
class SGDConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.0
    max_param_change: float = 2.0      # global, Kaldi default
    default_max_change: float = 0.75   # per-component, Kaldi default


def layer_hyperparams(model: Model) -> Dict[str, Dict[str, float]]:
    """Per-layer (lr_factor, max_change, l2) from the xconfig specs.
    max_change None = unset (SGDConfig default); an explicit 0 = no
    per-component limit (Kaldi skips the clip)."""
    out = {}
    for layer in model.layers:
        lr_factor = 1.0
        max_change: Optional[float] = None
        s = layer.spec
        if isinstance(s, (ConvReluBNSpec, OutputSpec)):
            lr_factor = s.learning_rate_factor
            max_change = s.max_change
        lr_factor = layer.config.get_float("learning-rate-factor", lr_factor)
        if "max-change" in layer.config.params:
            max_change = layer.config.get_float("max-change")
        l2 = getattr(s, "l2_reg", 0.0) or 0.0
        out[layer.name] = {"lr_factor": lr_factor, "max_change": max_change,
                           "l2": l2}
    return out


def init_sgd_state(params) -> dict:
    return {"velocity": {l: {k: torch.zeros_like(w.detach())
                             for k, w in p.items()}
                         for l, p in params.items()},
            "step": torch.zeros((), dtype=torch.int64,
                                device=_any_device(params))}


def _any_device(params):
    for p in params.values():
        for w in p.values():
            return w.device
    return None


@torch.no_grad()
def sgd_update(params, grads, opt_state, config: SGDConfig,
               lr: Optional[float] = None,
               hyper: Optional[Dict[str, Dict[str, float]]] = None,
               trainable: Optional[dict] = None,
               skip: Optional[torch.Tensor] = None,
               sharded: Optional[dict] = None, model_group=None):
    """One SGD step; grads are d loss / d w (descent).

    sharded: {layer: {name: bool}}, the leaves of which this rank holds a
    slice over `model_group` (a mesh's model axis); their squares in the
    per-component and global norms are summed over its ranks.

    Returns (new_params, new_opt_state, stats) with new tensors; the
    inputs are not modified.  skip: optional bool tensor; where True
    (non-finite batch) params and velocities keep their old values,
    selected, never multiplied by 0 (0 * inf would be NaN).
    """
    lr = config.learning_rate if lr is None else lr
    mu = config.momentum
    hyper = hyper or {}
    vel = opt_state["velocity"]
    new_vel: dict = {}
    deltas: dict = {}
    sq_norms = []
    l2_decay = {}
    # (layer, max_change, its deltas' squares: replicated, sharded)
    layers = []
    for lname, lparams in params.items():
        new_vel[lname] = {}
        deltas[lname] = {}
        h = hyper.get(lname, {})
        max_change = h.get("max_change")
        if max_change is None:
            max_change = config.default_max_change
        layer_lr = lr * h.get("lr_factor", 1.0)
        l2 = h.get("l2", 0.0)
        layer_sq, layer_sh = [], []
        for pname, w in lparams.items():
            if trainable is not None and not trainable[lname][pname]:
                new_vel[lname][pname] = vel[lname][pname]
                deltas[lname][pname] = torch.zeros_like(w)
                continue
            v = mu * vel[lname][pname] + grads[lname][pname].float()
            new_vel[lname][pname] = v
            d = layer_lr * v
            deltas[lname][pname] = d
            (layer_sh if model_group is not None and sharded[lname][pname]
             else layer_sq).append(torch.sum(d * d))
            if l2 > 0:
                l2_decay[(lname, pname)] = layer_lr * l2 * w
        layers.append((lname, max_change, layer_sq, layer_sh))
    if model_group is not None:
        # every layer's sharded squares, summed over the model ranks at once
        sh = [i for i, (*_, shl) in enumerate(layers) if shl]
        if sh:
            tot = torch.stack([sum(layers[i][3]) for i in sh])
            model_group.all_reduce(tot)
            for j, i in enumerate(sh):
                layers[i][2].append(tot[j])
    for lname, max_change, layer_sq, _ in layers:
        if layer_sq and max_change > 0:
            comp_norm = torch.sqrt(sum(layer_sq))
            comp_scale = torch.clamp(
                max_change / torch.clamp(comp_norm, min=1e-20), max=1.0)
            for pname in deltas[lname]:
                deltas[lname][pname] = deltas[lname][pname] * comp_scale
            sq_norms.append((comp_norm * comp_scale) ** 2)
        elif layer_sq:
            sq_norms.append(sum(layer_sq))

    device = _any_device(params)
    total_norm = (torch.sqrt(sum(sq_norms)) if sq_norms
                  else torch.zeros((), device=device))
    global_scale = torch.clamp(
        config.max_param_change / torch.clamp(total_norm, min=1e-20), max=1.0)

    new_params = {}
    for lname, lparams in params.items():
        new_params[lname] = {}
        for pname, w in lparams.items():
            new_w = w - global_scale * deltas[lname][pname]
            if (lname, pname) in l2_decay:
                new_w = new_w - l2_decay[(lname, pname)]
            if skip is not None:
                new_w = torch.where(skip, w, new_w)
                new_vel[lname][pname] = torch.where(
                    skip, vel[lname][pname], new_vel[lname][pname])
            new_params[lname][pname] = new_w

    stepped = (~skip).to(torch.int64) if skip is not None else 1
    new_state = {"velocity": new_vel, "step": opt_state["step"] + stepped}
    stats = {"param_change_norm": total_norm * global_scale,
             "global_clip_scale": global_scale}
    return new_params, new_state, stats
