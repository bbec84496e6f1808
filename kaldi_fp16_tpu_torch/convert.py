"""Parameter trees between the JAX package and the PyTorch port.

The JAX package keeps a network as two nested dicts, params[layer][name]
and state[layer] (BN statistics: {count, mean, var}, or {bn1: ..., bn2: ...}
for a prefinal layer).  The port keeps them in a `Network` module.  The
layouts agree except for conv weights: HWIO-flattened [kt*kh*nf_in,
nf_out] in JAX, OIHW [nf_out, nf_in, kt, kh] in the port.
`train_state_from_jax` / `train_state_to_numpy` and
`data_position_from_jax` carry a whole training state (velocities, step
count, NG states, loss scale, data position) across, so a JAX checkpoint
continues in the port.  The x-vector family's parameters
(`xvector_params_from_jax` / `_to_numpy`) and an Adam state
(`adam_state_from_jax` / `_to_numpy`) share the JAX layout and cross
unchanged.

On a mesh with a model axis (parallel/mesh.py) a rank holds its slices of
the sharded layers: `train_state_from_jax(..., mesh=)` cuts a JAX state
to them, and `params_to_numpy` / `train_state_to_numpy(..., mesh=)`
gather them whole (an all-reduce over the model axis on every rank).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.network import (
    Network, conv_weight_from_oihw, conv_weight_to_oihw, module_key,
)
from kaldi_fp16_tpu_torch.models.xconfig import LayerType


def _is_conv_weight(model: Model, lname: str, pname: str) -> bool:
    layer = model.layer_map[lname]
    return layer.type == LayerType.CONV_RELU_BATCHNORM and pname == "w"


def params_from_jax(model: Model, params: dict, state: dict
                    ) -> Dict[str, torch.Tensor]:
    """JAX (params, state) trees of numpy arrays -> the port's state_dict
    (parameters and BN buffers), for `Network.load_state_dict`."""
    sd: Dict[str, torch.Tensor] = {}
    for lname, p in params.items():
        key = module_key(lname)
        for pname, w in p.items():
            t = torch.tensor(np.asarray(w, np.float32))
            if _is_conv_weight(model, lname, pname):
                t = conv_weight_to_oihw(t, model.layer_map[lname].spec)
            sd[f"layers.{key}.{pname}"] = t
    for lname, st in state.items():
        key = module_key(lname)
        slots = {"bn": st} if "count" in st else st
        for slot, vals in slots.items():
            for name, v in vals.items():
                sd[f"layers.{key}.{slot}.{name}"] = torch.tensor(
                    np.asarray(v, np.float32))
    return sd


def params_to_numpy(net: Network, mesh=None) -> Tuple[dict, dict]:
    """The port's parameters and BN statistics as JAX-layout (params,
    state) trees of numpy arrays (whole: gathered over a mesh's model
    axis)."""
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        gather_params, param_shardings,
    )
    from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes
    model = net.model
    params = {}
    whole = gather_params(net.params, param_shardings(model, mesh, net.params),
                          mesh_axes(mesh).model)
    for lname, p in whole.items():
        params[lname] = {}
        for pname, w in p.items():
            w = w.detach()
            if _is_conv_weight(model, lname, pname):
                w = conv_weight_from_oihw(w, model.layer_map[lname].spec)
            params[lname][pname] = w.cpu().numpy().copy()

    def to_np(tree):
        return {k: to_np(v) if isinstance(v, dict) else v.cpu().numpy().copy()
                for k, v in tree.items()}

    return params, to_np(net.bn_state())


def _tree(x):
    """A NamedTuple (NGState, LossScaleState) or dict as a dict."""
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def train_state_from_jax(model: Model, params: dict, net_state: dict,
                         opt_state: dict, scale_state, device=None,
                         mesh=None):
    """A JAX training state (the trees of the JAX `init_train_state` or of a
    restored JAX checkpoint, numpy or jax arrays) -> (the port's
    state_dict for `Network.load_state_dict`, opt_state, scale_state) on
    `device` (default: the current CUDA device).

    opt_state carries the SGD velocities (conv weights re-laid out to OIHW,
    as `params_from_jax` does), the step count and, when present, the NG
    states per site ({"in": NGState, "out": NGState}); scale_state becomes
    the port's LossScaleState.  mesh: the state_dict and the velocities
    are this rank's slices over the mesh's model axis."""
    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        param_shardings, shard_params, shard_state_dict,
    )
    from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes
    from kaldi_fp16_tpu_torch.training.loss_scale import LossScaleState
    from kaldi_fp16_tpu_torch.training.natural_gradient import NGState

    device = resolve_device(device)
    sd = shard_state_dict(params_from_jax(model, params, net_state), model,
                          mesh)

    def tensor(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    velocity = {}
    for lname, p in opt_state["velocity"].items():
        velocity[lname] = {}
        for pname, v in p.items():
            t = tensor(v, torch.float32)
            if _is_conv_weight(model, lname, pname):
                t = conv_weight_to_oihw(t, model.layer_map[lname].spec)
            velocity[lname][pname] = t
    tp = mesh_axes(mesh).model
    if tp is not None:
        velocity = {l: {k: v.clone() for k, v in p.items()} for l, p in
                    shard_params(velocity, param_shardings(model, mesh,
                                                           velocity),
                                 tp.rank, tp.world).items()}
    out = {"velocity": velocity,
           "step": tensor(opt_state["step"], torch.int64)}
    if "ng" in opt_state:
        out["ng"] = {
            site: {side: NGState(**{k: tensor(v) for k, v in
                                    _tree(st[side]).items()})
                   for side in ("in", "out")}
            for site, st in opt_state["ng"].items()}
    scale = LossScaleState(**{k: tensor(v) for k, v in
                              _tree(scale_state).items()})
    return sd, out, scale


def train_state_to_numpy(net: Network, opt_state: dict, scale_state,
                         mesh=None):
    """The port's training state as JAX-layout numpy trees: (params,
    net_state, opt_state, scale_state dict), opt_state with "velocity"
    (conv weights in the JAX layout), "step" (int32) and, when present,
    "ng" ({site: {"in"/"out": {v, d, rho, t}}}); whole, gathered over a
    mesh's model axis."""
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        gather_params, param_shardings,
    )
    from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes
    model = net.model
    params, state = params_to_numpy(net, mesh)
    vel = opt_state["velocity"]
    vel = gather_params(vel, param_shardings(model, mesh, vel),
                        mesh_axes(mesh).model)
    velocity = {}
    for lname, p in vel.items():
        velocity[lname] = {}
        for pname, v in p.items():
            v = v.detach()
            if _is_conv_weight(model, lname, pname):
                v = conv_weight_from_oihw(v, model.layer_map[lname].spec)
            velocity[lname][pname] = v.cpu().numpy().copy()
    out = {"velocity": velocity,
           "step": np.asarray(int(opt_state["step"]), np.int32)}
    if "ng" in opt_state:
        out["ng"] = {site: {side: {k: v.cpu().numpy().copy() for k, v in
                                   _tree(st[side]).items()}
                            for side in ("in", "out")}
                     for site, st in opt_state["ng"].items()}
    scale = {k: v.cpu().numpy().copy() for k, v in _tree(scale_state).items()}
    return params, state, out, scale


def data_position_from_jax(pos):
    """A JAX `DataPosition` (epoch, file_index, batches_consumed, rng_key)
    -> the port's.  The JAX PRNG key has no torch generator state, so
    `rng_state` is None: the resumed run draws its SpecAugment masks from
    the Trainer's seeded generator."""
    from kaldi_fp16_tpu_torch.training.checkpoint import DataPosition
    return DataPosition(epoch=int(pos.epoch), file_index=int(pos.file_index),
                        batches_consumed=int(pos.batches_consumed))


def _tensors(tree, device, dtype=None, requires_grad=False):
    """A nested dict of arrays -> the same dict of tensors on `device`."""
    return {k: (_tensors(v, device, dtype, requires_grad)
                if isinstance(v, dict) else
                torch.tensor(np.asarray(v), dtype=dtype, device=device,
                             requires_grad=requires_grad))
            for k, v in tree.items()}


def _arrays(tree):
    """A nested dict of tensors -> the same dict of numpy arrays."""
    return {k: (_arrays(v) if isinstance(v, dict)
                else v.detach().cpu().numpy().copy())
            for k, v in tree.items()}


def xvector_params_from_jax(params: dict, device=None) -> dict:
    """A JAX x-vector parameter tree ({layer: {"w": [in, out], "b"}}) ->
    the port's: fp32 leaves that require grad, on `device` (default: the
    current CUDA device)."""
    from kaldi_fp16_tpu_torch.device import resolve_device
    return _tensors(params, resolve_device(device), torch.float32, True)


def xvector_params_to_numpy(params: dict) -> dict:
    return _arrays(params)


def adam_state_from_jax(state: dict, device=None) -> dict:
    """A JAX Adam state ({"m", "v", "step"}) -> the port's, on `device`."""
    from kaldi_fp16_tpu_torch.device import resolve_device
    device = resolve_device(device)
    return {"m": _tensors(state["m"], device, torch.float32),
            "v": _tensors(state["v"], device, torch.float32),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def adam_state_to_numpy(state: dict) -> dict:
    return {"m": _arrays(state["m"]), "v": _arrays(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}
