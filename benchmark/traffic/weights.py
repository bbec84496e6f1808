"""The network's weights, drawn on the device from a run's seed.

Xavier-normal weights (std sqrt(2 / (fan_in + fan_out)), the port's and the
JAX package's initialiser) and zero biases, for the trainable leaves of a
configuration (reference/network.py `param_shapes`), in one draw of all
their normal deviates on the device.  The same seed gives the same weights
to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.network import param_shapes


def _fans(shape) -> tuple:
    if len(shape) == 4:                     # OIHW conv weight
        return shape[1] * shape[2] * shape[3], shape[0]
    return shape[0], shape[1]


def make_weights(model, seed: int, device) -> dict:
    """{layer: {name: float32 tensor}} on `device`."""
    shapes = param_shapes(model)
    mats = [(l, k, s) for l, p in shapes.items() for k, s in p.items()
            if len(s) > 1]
    total = sum(math.prod(s) for _, _, s in mats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out = {l: {} for l in shapes}
    off = 0
    for l, k, s in mats:
        n = math.prod(s)
        fan_in, fan_out = _fans(s)
        out[l][k] = flat[off:off + n].view(s) * math.sqrt(
            2.0 / (fan_in + fan_out))
        off += n
    for l, p in shapes.items():
        for k, s in p.items():
            if len(s) == 1:
                out[l][k] = torch.zeros(s, device=device)
    return {l: {k: out[l][k] for k in shapes[l]} for l in shapes}
