"""How exact NG-SGD's Fisher update is at flagship width, by device,
precision and eigensolver.

    python -m kaldi_fp16_tpu_torch.tools.ng_precision [--batch 128]
        [--frames-in 164] [--frames-out 50] [--xconfig configs/cnn_tdnn.xconfig]

One step of the recipe's training options (configs/train_flagship.sh:
xent 0.1, loss scaling, l2 5e-5, NG-SGD at the default ranks 20 / 80, so
patch-lowered convs) runs on the card from seed 7, its first, so every NG
counter is due.  What its NG calls (`update_ng_states`, then
`apply_natural_gradient`) get and give is recorded (`record_ng_step`), and
the same calls re-run from the recorded states, inputs X, output
derivatives G and grads (`ng_calls`) as:

  card_fp32             the port as it trains (eigensolves in float64)
  card_fp32_eigh32      float32 eigensolves (cuSOLVER)
  card_fp32_eigh32_magma  the same through MAGMA
  card_fp64, cpu_fp32, cpu_fp32_eigh32 (LAPACK)

each against the CPU in float64, in multiples of the bars of
tests/test_torch_natural_gradient.py (`ng_excess`: d, rho, Vᵀdiag(d)V of
both states of a site and its preconditioned grads).  One JSON line per
run: the largest multiple over the sites whose states keep under half
their dimensions (`well_posed`), and over the others, where float32 is
ill-conditioned (training/natural_gradient.py).  The first line is the
card's name and power limit as nvidia-smi gives them.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.tools.profile_step import ROOT, supervision
from kaldi_fp16_tpu_torch.training import natural_gradient
from kaldi_fp16_tpu_torch.training import train_step as ts
from kaldi_fp16_tpu_torch.training.natural_gradient import update_due

RTOL = 1e-4          # tests/test_torch_natural_gradient.py
CPU = torch.device("cpu")


def cast(tree, device, dtype=None):
    """A copy of nested dicts / tuples of tensors on `device`, floating
    tensors in `dtype` (kept as they are if None)."""
    if isinstance(tree, dict):
        return {k: cast(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(cast(v, device, dtype) for v in tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if dtype is not None and tree.is_floating_point():
        return tree.to(device, dtype)
    return tree.to(device)


def excess(a, r, rtol, atol):
    """How far a lies outside r's bar |a - r| <= atol + rtol |r|, as a
    multiple of that bar (<= 1: within it)."""
    diff = (a.double() - r.double()).abs()
    bar = atol + rtol * r.double().abs()
    ratio = torch.where(bar > 0, diff / bar.clamp(min=1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    return float(ratio.max())


def ng_excess(run, ref, sites, grads):
    """{site: multiple of its bar} of one NG run (new states, new grads,
    on the CPU) against another: the largest over d (rtol 1e-4, atol 1e-4
    max d), rho (rtol 1e-4) and Vᵀdiag(d)V (1e-4 of its largest entry) of
    both states, and the preconditioned grads (rtol 1e-4, atol 1e-6 ||dw||,
    dw the site's gradient with its bias row); inf where a counter t
    differs."""
    (new_a, pre_a), (new_r, pre_r) = run, ref
    out = {}
    for site in sites:
        nm, worst = site["name"], 0.0
        for side in ("in", "out"):
            a, r = new_a[nm][side], new_r[nm][side]
            if int(a.t) != int(r.t):
                worst = float("inf")
            cov_a = (a.v.double().T * a.d.double()) @ a.v.double()
            cov_r = (r.v.double().T * r.d.double()) @ r.v.double()
            worst = max(worst,
                        excess(a.d, r.d, RTOL, RTOL * float(r.d.max())),
                        excess(a.rho, r.rho, RTOL, 0.0),
                        excess(cov_a, cov_r, 0.0,
                               RTOL * float(cov_r.abs().max())))
        g = grads[site["layer"]]
        names = [site["w"]] + ([site["b"]] if site["b"] is not None else [])
        dw_norm = float(torch.sqrt(sum(torch.sum(g[k].double() ** 2)
                                       for k in names)))
        for k in names:
            worst = max(worst, excess(pre_a[site["layer"]][k],
                                      pre_r[site["layer"]][k], RTOL,
                                      1e-6 * dw_norm))
        out[nm] = worst
    return out


def well_posed(states) -> list:
    """Sites whose two states keep under half their dimensions (2R < D -
    1), where the update is well-conditioned in float32."""
    return [nm for nm, st in states.items()
            if all(2 * s.v.shape[0] < s.v.shape[1] - 1 for s in st.values())]


def record_ng_step(dev, den, batch=128, frames_in=164, frames_out=50,
                   xconfig=None, left_context=3):
    """One recipe step with NG on `dev` (its first: every counter due),
    from seed 7.  Returns the record: the model, the sites, the NG calls'
    inputs (states, xs, gs, counters, cfg_in, cfg_out, grads) and outputs
    (new, pre), and the step's output."""
    rng = np.random.default_rng(7)
    model = build_model(xconfig or str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    pdfs = model.chain_output().spec.output_dim
    config = ts.TrainConfig(learning_rate=1e-3, left_context=left_context,
                            xent_regularize=0.1, use_loss_scaling=True,
                            natural_gradient=True)
    net, opt, scale = ts.init_train_state(
        model, torch.Generator().manual_seed(0), config, device=dev)
    step = ts.make_train_step(
        model, net, den, supervision(batch, frames_out, 256, pdfs, rng),
        ChainTrainingOpts(l2_regularize=5e-5, xent_regularize=0.1), config,
        num_frames_out=frames_out)
    inputs = {
        "features": torch.from_numpy(rng.normal(
            size=(batch, frames_in, 40)).astype(np.float32)).to(dev),
        "ivectors": torch.from_numpy(rng.normal(
            size=(batch, 100)).astype(np.float32)).to(dev),
        "weights": torch.ones(batch, device=dev)}
    seen = {}
    real = {"update": ts.update_ng_states,
            "apply": ts.apply_natural_gradient}

    def recorder(name):
        def call(*args):
            out = real[name](*args)
            seen[name] = (args, out)
            return out
        return call

    ts.update_ng_states = recorder("update")
    ts.apply_natural_gradient = recorder("apply")
    try:
        _, _, out = step(opt, scale, inputs,
                         generator=torch.Generator(device=dev).manual_seed(1))
    finally:
        ts.update_ng_states = real["update"]
        ts.apply_natural_gradient = real["apply"]
    sites, states, xs, gs, counters, cfg_in, cfg_out = seen["update"][0][:7]
    if not all(update_due(c, cfg_in if side == "in" else cfg_out)
               for (_, side), c in counters.items()):
        raise AssertionError("not every NG counter was due in the first step")
    return dict(model=model, sites=sites, states=states, xs=xs, gs=gs,
                counters=counters, cfg_in=cfg_in, cfg_out=cfg_out,
                grads=seen["apply"][0][3], new=seen["update"][1],
                pre=seen["apply"][1], out=out)


def ng_calls(rec, device, dtype):
    """The recorded step's NG calls re-run on `device` with the states and
    grads in `dtype` (the samples follow the states); (new states, new
    grads) on the CPU."""
    new = ts.update_ng_states(rec["sites"], cast(rec["states"], device, dtype),
                              rec["xs"], rec["gs"], rec["counters"],
                              rec["cfg_in"], rec["cfg_out"])
    pre = ts.apply_natural_gradient(rec["model"], rec["sites"], new,
                                    cast(rec["grads"], device, dtype),
                                    rec["cfg_in"])
    return cast(new, CPU), cast(pre, CPU)


def _eigh32(a):
    return torch.linalg.eigh(a)


def with_eigh(fn, eigh):
    """fn() with natural_gradient's eigensolver replaced by `eigh`."""
    kept = natural_gradient._eigh
    natural_gradient._eigh = eigh
    try:
        return fn()
    finally:
        natural_gradient._eigh = kept


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=164)
    ap.add_argument("--frames-out", type=int, default=50)
    ap.add_argument("--xconfig", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ng_precision: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_model(args.xconfig
                        or str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    pdfs = model.chain_output().spec.output_dim
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_phone_lm_den_fst(num_pdfs=pdfs), pdfs), leaky=1e-5, device=dev)
    rec = record_ng_step(dev, den, args.batch, args.frames_in,
                         args.frames_out, args.xconfig)
    f32, f64 = torch.float32, torch.float64
    runs = {"card_fp32": (cast(rec["new"], CPU), cast(rec["pre"], CPU))}
    runs["card_fp32_eigh32"] = with_eigh(lambda: ng_calls(rec, dev, f32),
                                         _eigh32)
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        runs["card_fp32_eigh32_magma"] = with_eigh(
            lambda: ng_calls(rec, dev, f32), _eigh32)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    runs["card_fp64"] = ng_calls(rec, dev, f64)
    for key in ("states", "xs", "gs", "grads"):
        rec[key] = cast(rec[key], CPU)
    runs["cpu_fp32"] = ng_calls(rec, CPU, f32)
    runs["cpu_fp32_eigh32"] = with_eigh(lambda: ng_calls(rec, CPU, f32),
                                        _eigh32)
    ref = ng_calls(rec, CPU, f64)
    posed = set(well_posed(rec["states"]))
    for name, run in runs.items():
        e = ng_excess(run, ref, rec["sites"], rec["grads"])
        good = [v for k, v in e.items() if k in posed]
        ill = [v for k, v in e.items() if k not in posed]
        print(json.dumps({
            "run": name, "against": "cpu_fp64",
            "well_posed_sites": len(good), "well_posed_max": max(good),
            "well_posed_over_bar": sum(v > 1 for v in good),
            "ill_posed_sites": len(ill), "ill_posed_max": max(ill),
            "ill_posed_over_bar": sum(v > 1 for v in ill)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
