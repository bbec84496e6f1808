"""backtest: autograd against central finite differences, per layer type
and through the whole stack.

The twin of tools/backtest.py: the same seven xconfigs (linear,
relu-batchnorm, tdnnf, conv, attention, prefinal + output, the full
stack), the same loss (the eval forward's output, fp32, against a fixed
random projection) and the same probes (a few random coordinates of every
parameter), run in fp32 with TF32 off on --device (default: the current
CUDA device).  Coordinates are drawn in the JAX package's parameter
layout, in its tree order (layers, then parameters, by name), so one
numpy seed probes the JAX tool's coordinates; conv weights are converted
to and from the port's OIHW layout (convert.py).

`gradcheck(cfg, params=None, state=None, proj=None, ...)` takes the JAX
layout's (params, state) trees of numpy arrays and the projection as
numpy, so a test can hand it the JAX init and jax.random's projection;
with none it draws its own (weights from a seed-1 CPU generator, the
projection from seed 7).

Usage:
  python -m kaldi_fp16_tpu_torch.tools.backtest [--eps 1e-3] [--probes 6]
      [--tol 2e-2] [--device cpu]

`main(argv)` returns {"failures", "worst": {name: max rel err}}; run as a
program it exits 1 on a failure.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.convert import (
    _is_conv_weight, params_from_jax, params_to_numpy,
)
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import (
    Network, conv_weight_from_oihw,
)
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device

CONFIGS = [
    ("linear", """\
input name=input dim=10
linear-component name=l1 dim=12
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("relu-batchnorm", """\
input name=input dim=10
relu-batchnorm-layer name=l1 dim=12
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("tdnnf (stride 3, bypass)", """\
input name=input dim=12
linear-component name=l0 dim=16
tdnnf-layer name=t1 dim=16 bottleneck-dim=8 time-stride=3
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("conv-relu-batchnorm", """\
input name=input dim=24
conv-relu-batchnorm-layer name=c1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("attention", """\
input name=input dim=16
attention-relu-batchnorm-layer name=a1 num-heads=2 value-dim=4 key-dim=4 num-left-inputs=2 num-right-inputs=1
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("prefinal+output", """\
input name=input dim=10
prefinal-layer name=pf big-dim=16 small-dim=8
output-layer name=output dim=6 include-log-softmax=false
"""),
    ("full stack", """\
input name=ivector dim=8
input name=input dim=10
idct-layer name=idct input=input dim=10
linear-component name=iv dim=6 input=ReplaceIndex(ivector, t, 0)
linear-component name=l1 input=Append(idct, iv) dim=16
tdnnf-layer name=t1 dim=16 bottleneck-dim=8 time-stride=3
prefinal-layer name=pf big-dim=16 small-dim=8
output-layer name=output dim=6 include-log-softmax=false
"""),
]


def gradcheck(cfg, params=None, state=None, proj=None, *, rng, eps=1e-3,
              probes=6, device="cpu", B=2, T=8) -> dict:
    """Autograd vs central differences on one xconfig.  params / state:
    JAX-layout trees of numpy arrays (default: a seed-1 init); proj: the
    [B, T, out_dim] projection (default: drawn from seed 7).  Draws the
    inputs and the probed coordinates from `rng` as the JAX tool does.
    Returns {"worst": max relative error, "grads": the autograd gradients
    as a JAX-layout tree of numpy arrays}."""
    device = torch.device(device)
    model = build_model_from_string(cfg)
    net = Network(model, torch.Generator().manual_seed(1), device)
    if params is not None:
        net.load_state_dict(params_from_jax(model, params, state),
                            strict=True)
    net.eval()
    base, base_state = params_to_numpy(net)
    feat_dim = model.layer_map["input"].output_dim
    has_ivec = "ivector" in model.layer_map
    feats = torch.from_numpy(
        rng.normal(size=(B, T, feat_dim)).astype(np.float32)).to(device)
    ivecs = (torch.from_numpy(rng.normal(
        size=(B, model.layer_map["ivector"].output_dim)).astype(np.float32)
    ).to(device) if has_ivec else None)
    rng.normal(size=1)       # the JAX tool's unused probe draw
    w = (None if proj is None
         else torch.tensor(np.asarray(proj, np.float32), device=device))

    def loss():
        nonlocal w
        outs, _ = net(feats, ivecs, train=False,
                      compute_dtype=torch.float32)
        out = outs["output"].float()
        if w is None:
            w = torch.randn(out.shape, generator=torch.Generator()
                            .manual_seed(7)).to(device)
        return torch.sum(out * w)

    net.zero_grad()
    loss().backward()
    grads = {}
    for lname, p in net.params.items():
        grads[lname] = {}
        for pname, v in p.items():
            g = v.grad.detach()
            if _is_conv_weight(model, lname, pname):
                g = conv_weight_from_oihw(g, model.layer_map[lname].spec)
            grads[lname][pname] = g.cpu().numpy()

    def loss_at(lname, pname, arr):
        tree = {ln: dict(p) for ln, p in base.items()}
        tree[lname][pname] = arr
        net.load_state_dict(params_from_jax(model, tree, base_state))
        with torch.no_grad():
            return float(loss())

    worst = 0.0
    for lname in sorted(base):
        for pname in sorted(base[lname]):
            arr = base[lname][pname]
            if arr.size == 0:
                continue
            for _ in range(probes):
                idx = tuple(rng.integers(0, s) for s in arr.shape)
                a1, a2 = np.array(arr), np.array(arr)
                a1[idx] += eps
                a2[idx] -= eps
                fd = (loss_at(lname, pname, a1)
                      - loss_at(lname, pname, a2)) / (2 * eps)
                ga = float(grads[lname][pname][idx])
                err = abs(fd - ga) / max(1.0, abs(fd), abs(ga))
                worst = max(worst, err)
    return {"worst": worst, "grads": grads}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.backtest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--probes", type=int, default=6)
    ap.add_argument("--tol", type=float, default=2e-2,
                    help="relative tolerance on |fd - analytic|")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = tool_device("backtest", args.device)

    rng = np.random.default_rng(0)
    failures = 0
    worst = {}
    print("per-layer-type gradient checks (autograd vs central "
          "differences, fp32, TF32 off):")
    with fp32_matmuls():
        for name, cfg in CONFIGS:
            err = gradcheck(cfg, rng=rng, eps=args.eps, probes=args.probes,
                            device=dev)["worst"]
            ok = err <= args.tol
            print(f"  {'OK ' if ok else 'FAIL'} {name:28s} max rel err "
                  f"{err:.2e}")
            worst[name] = err
            if not ok:
                failures += 1
    print("PASS" if failures == 0 else f"FAIL ({failures})")
    return {"failures": failures, "worst": worst}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
