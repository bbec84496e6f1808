"""sgdtest: the optimizer against host-computed expectations: plain SGD,
momentum, per-component and global max-change, the learning-rate factor,
the loss-scale overflow skip, schedule and unscale, and 10 descending
steps on a quadratic loss.

The twin of tools/sgdtest.py, on the port's training/optimizer.py and
training/loss_scale.py, with every tensor on --device (default: the
current CUDA device) and TF32 off.  The same checks and lines.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.sgdtest [--device cpu]

`main(argv)` returns {"failures", "checks": [(name, ok)]}; run as a
program it exits 1 on a failure.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device
from kaldi_fp16_tpu_torch.training.loss_scale import (
    grads_finite, init_loss_scale, unscale_grads, update_loss_scale,
)
from kaldi_fp16_tpu_torch.training.optimizer import (
    SGDConfig, init_sgd_state, sgd_update,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.sgdtest",
        description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = tool_device("sgdtest", args.device)
    with fp32_matmuls():
        return run(dev)


def run(dev) -> dict:
    failures = 0
    checks = []

    def check(name, ok, detail=""):
        nonlocal failures
        ok = bool(ok)
        print(f"  {'OK ' if ok else 'FAIL'} {name} {detail}")
        checks.append((name, ok))
        if not ok:
            failures += 1

    def on(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    def host(t):
        return t.detach().cpu().numpy()

    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    g0 = rng.normal(size=(4, 3)).astype(np.float32)
    params = {"l": {"w": on(w0)}}
    grads = {"l": {"w": on(g0)}}

    print("basic SGD (no momentum, no clip):")
    cfg = SGDConfig(learning_rate=0.1, momentum=0.0,
                    max_param_change=1e9, default_max_change=1e9)
    p1, s1, _ = sgd_update(params, grads, init_sgd_state(params), cfg)
    check("w -= lr*g", np.allclose(host(p1["l"]["w"]), w0 - 0.1 * g0,
                                   atol=1e-6))

    print("momentum (2 steps):")
    cfg = SGDConfig(learning_rate=0.1, momentum=0.9,
                    max_param_change=1e9, default_max_change=1e9)
    st = init_sgd_state(params)
    p1, st, _ = sgd_update(params, grads, st, cfg)
    p2, st, _ = sgd_update(p1, grads, st, cfg)
    v1 = g0
    v2 = 0.9 * v1 + g0
    check("v = mu*v + g accumulates",
          np.allclose(host(p2["l"]["w"]), w0 - 0.1 * v1 - 0.1 * v2,
                      atol=1e-6))

    print("per-component max-change:")
    cfg = SGDConfig(learning_rate=1.0, momentum=0.0,
                    max_param_change=1e9, default_max_change=0.5)
    p1, _, stats = sgd_update(params, grads, init_sgd_state(params), cfg)
    norm = np.linalg.norm(host(p1["l"]["w"]) - w0)
    check("||delta|| clipped to 0.5", abs(norm - 0.5) < 1e-4,
          f"(norm={norm:.4f})")

    print("global max-param-change over two components:")
    params2 = {"a": {"w": on(w0)}, "b": {"w": on(w0)}}
    grads2 = {"a": {"w": on(g0)}, "b": {"w": on(g0)}}
    cfg = SGDConfig(learning_rate=1.0, momentum=0.0,
                    max_param_change=0.4, default_max_change=1e9)
    p1, _, stats = sgd_update(params2, grads2, init_sgd_state(params2), cfg)
    total = np.sqrt(sum(np.linalg.norm(host(p1[k]["w"]) - w0) ** 2
                        for k in ("a", "b")))
    check("global norm clipped to 0.4", abs(total - 0.4) < 1e-4,
          f"(norm={total:.4f})")
    check("stats report the clip",
          abs(float(stats["param_change_norm"]) - 0.4) < 1e-4)

    print("learning-rate factor via hyper:")
    cfg = SGDConfig(learning_rate=0.1, momentum=0.0,
                    max_param_change=1e9, default_max_change=1e9)
    hyper = {"l": {"lr_factor": 0.5, "max_change": 0.0}}
    p1, _, _ = sgd_update(params, grads, init_sgd_state(params), cfg,
                          hyper=hyper)
    check("lr * factor applied", np.allclose(host(p1["l"]["w"]),
                                             w0 - 0.05 * g0, atol=1e-6))

    print("loss-scale overflow skip:")
    bad = {"l": {"w": on(np.full((4, 3), np.inf, np.float32))}}
    finite = grads_finite(bad)
    check("overflow detected", not bool(finite))
    p1, s1, _ = sgd_update(params, bad, init_sgd_state(params), cfg,
                           skip=~finite)
    check("params untouched on skip", np.array_equal(host(p1["l"]["w"]), w0))
    check("step not incremented", int(s1["step"]) == 0)

    print("loss-scale schedule (init 65536, growth 2x/2000, backoff 0.5):")
    ls = init_loss_scale(device=dev)
    check("init 65536", float(ls.scale) == 65536.0)
    no = torch.tensor(False, device=dev)
    yes = torch.tensor(True, device=dev)
    ls2, skip2 = update_loss_scale(ls, no)
    check("backoff 0.5 on overflow", float(ls2.scale) == 32768.0)
    check("skip flagged on overflow", bool(skip2))
    ls3 = ls
    for _ in range(2000):
        ls3, _ = update_loss_scale(ls3, yes)
    check("growth 2x after 2000 good steps", float(ls3.scale) == 131072.0,
          f"(scale={float(ls3.scale)})")
    g = {"l": {"w": on(g0 * float(ls.scale))}}
    gu = unscale_grads(g, ls)
    check("unscale divides by scale", np.allclose(host(gu["l"]["w"]), g0,
                                                  atol=1e-6))

    print("through-network: 10 steps on a quadratic loss must descend:")
    target = on(rng.normal(size=(4, 3)).astype(np.float32))
    p = {"l": {"w": on(w0)}}
    st = init_sgd_state(p)
    cfg = SGDConfig(learning_rate=0.2, momentum=0.5)
    loss0 = None
    for _ in range(10):
        w = p["l"]["w"].clone().requires_grad_(True)
        loss = torch.sum((w - target) ** 2)
        (gr,) = torch.autograd.grad(loss, w)
        if loss0 is None:
            loss0 = float(loss.detach())
        p, st, _ = sgd_update(p, {"l": {"w": gr}}, st, cfg)
    loss_n = float(torch.sum((p["l"]["w"] - target) ** 2))
    check("loss decreased", loss_n < loss0, f"({loss0:.4f} -> {loss_n:.4f})")

    print("PASS" if failures == 0 else f"FAIL ({failures})")
    return {"failures": failures, "checks": checks}


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
