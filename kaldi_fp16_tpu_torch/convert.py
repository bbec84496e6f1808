"""Parameter trees between the JAX package and the PyTorch port.

The JAX package keeps a network as two nested dicts, params[layer][name]
and state[layer] (BN statistics: {count, mean, var}, or {bn1: ..., bn2: ...}
for a prefinal layer).  The port keeps them in a `Network` module.  The
layouts agree except for conv weights: HWIO-flattened [kt*kh*nf_in,
nf_out] in JAX, OIHW [nf_out, nf_in, kt, kh] in the port.
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


def params_to_numpy(net: Network) -> Tuple[dict, dict]:
    """The port's parameters and BN statistics as JAX-layout (params,
    state) trees of numpy arrays."""
    model = net.model
    params = {}
    for lname, p in net.params.items():
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
