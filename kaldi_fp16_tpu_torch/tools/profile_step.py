"""profile_step on PyTorch: attribute bench.py's flagship train step by
in-context ablation.

The twin of tools/profile_step.py.  Every variant is the same
make_train_step step at one geometry with exactly one stage replaced by a
zero-cost stand-in, so `full - variant` is that stage's cost in context:

  full      the production step: the structured den (the fused scans on a
            card), momentum, max-change, the orthonormal constraint
  no-den    the den forward-backward replaced by zeros (`_ZeroDen`); the
            numerator, the OOR penalty, the combine, the network and the
            optimizer unchanged
  no-num    the numerator forward-backward replaced by zeros (swapped in
            chain.objective for the variant)
  no-chain  the whole chain objective replaced by 1e-6 * sum(output),
            whose gradient still drives the whole network backward
            (swapped in training.train_step for the variant)
  fwd-only  the network forward (train=True, bf16), the output subsampled
            and summed under torch.no_grad: no backward, no update
  lean      (--lean) the full step without the optimizer extras: momentum
            0, no orthonormal constraint, no max-change

Usage:
  python -m kaldi_fp16_tpu_torch.tools.profile_step [--batch 128]
      [--frames-in 150] [--pdfs 3080] [--iters 15] [--lean]
      [--xconfig configs/cnn_tdnn.xconfig] [--device cpu]

The geometry is the JAX tool's: bench.py's step (lr 1e-3, momentum 0.9,
frame subsampling 3, left context 3) on the phone-LM den (leaky 1e-5) and
a linear numerator graph of max(256, T_out) arcs, on a random batch from
seed 0; every variant starts from the same init (seed 0) and SpecAugment
generator (seed 1).  Each variant runs one warm-up step, then --iters
steps: `wall_ms` per step is the host clock around steps that end in a
synchronise (the JAX tool's perf_counter + block_until_ready),
`device_ms` the CUDA events' elapsed time around the same steps (null on
the CPU: not measured), `launches` the hand-written kernels' launches in
all of the variant's steps, warm-up included (0 on the CPU, which runs
the plain versions), `loss` the warm-up step's loss (fwd-only:
`output_sum`, its summed output) and `scan_used` the scans of the den it
ran (null where none ran).  The text lines are the JAX tool's, each
variant's device ms beside its wall ms; then one JSON line with every
variant.  The first line is the card's name and power limit.  Runs on the
card unless given --device.  `main(argv)` returns the variants' dict.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import kaldi_fp16_tpu_torch.chain.objective as objective_mod
import kaldi_fp16_tpu_torch.training.train_step as ts_mod
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    LOG_ZERO, DenominatorGraph, NumeratorGraphBatch, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.chain.objective import (
    ChainResult, ChainTrainingOpts,
)
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.models.network import subsample_output
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, kernel_launches, tool_device,
)
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from kaldi_fp16_tpu_torch.utils.profiling import sync_device

ROOT = Path(__file__).resolve().parents[2]


def supervision(n_seq, n_frames, n_arcs, n_pdfs, rng):
    """bench.py's linear supervision chain with alternative-pdf arcs."""
    Sn = n_frames + 1
    arcs = np.arange(n_arcs, dtype=np.int32) % n_frames
    return NumeratorGraphBatch(
        arc_src=np.tile(arcs, (n_seq, 1)),
        arc_dst=np.tile(arcs + 1, (n_seq, 1)),
        arc_pdf=rng.integers(0, n_pdfs, size=(n_seq, n_arcs)).astype(np.int32),
        arc_logw=np.zeros((n_seq, n_arcs), np.float32),
        arc_mask=np.ones((n_seq, n_arcs), np.float32),
        start=np.zeros(n_seq, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(n_seq, 0),
        num_states=Sn, num_arcs=n_arcs)


class _ZeroDen:
    """Stand-in den: zero log-probs, zero posteriors.  The chain combine
    and containment stay; the den scans and posteriors are gone."""

    def forward_backward(self, nnet_output):
        return (torch.zeros(nnet_output.shape[0], dtype=torch.float32,
                            device=nnet_output.device),
                torch.zeros_like(nnet_output))


def _zero_num(num_graph, nnet_output):
    return (torch.zeros(nnet_output.shape[0], dtype=torch.float32,
                        device=nnet_output.device),
            torch.zeros_like(nnet_output))


def _trivial_objf_factory(num_graph, den, opts):
    """Differentiable stand-in for the whole chain objective: its gradient
    (1e-6 everywhere) still drives the whole network backward."""

    def objf_fn(nnet_output, weights, deriv_weights):
        B, T, _ = nnet_output.shape
        dev = nnet_output.device
        objf = torch.sum(nnet_output) * 1e-6
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        result = ChainResult(
            total_objf=objf.detach(), l2_term=zero,
            total_weight=torch.sum(weights) * T,
            num_logprob=torch.zeros(B, dtype=torch.float32, device=dev),
            den_logprob=torch.zeros(B, dtype=torch.float32, device=dev),
            objf_per_frame=objf.detach() / (B * T),
            out_of_range_count=torch.zeros((), dtype=torch.int64,
                                           device=dev),
            ok=torch.ones(B, dtype=torch.bool, device=dev))
        return objf, result, torch.zeros_like(nnet_output)

    return objf_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=150)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--xconfig", default=str(ROOT / "configs" /
                                             "cnn_tdnn.xconfig"))
    ap.add_argument("--lean", action="store_true",
                    help="also measure the optimizer-extras ablation")
    device_arg(ap, "the steps")
    return ap.parse_args(argv)


def measure(name, run, iters, dev) -> dict:
    """One warm-up run, then `iters` runs of `run` (which returns a scalar
    tensor): wall and device ms per run, the kernels' launches in all of
    them, and the warm-up run's value."""
    before = kernel_launches()
    first = float(run())
    sync_device(dev)
    cuda = dev.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    if cuda:
        end.record()
    sync_device(dev)
    wall = (time.perf_counter() - t0) * 1e3 / iters
    after = kernel_launches()
    return {"wall_ms": wall,
            "device_ms": start.elapsed_time(end) / iters if cuda else None,
            "launches": {k: after[k] - before[k] for k in after},
            ("output_sum" if name == "fwd-only" else "loss"): first}


def main(argv=None, state_dict=None) -> dict:
    """state_dict: the network's initial weights (default: the port's
    init from seed 0), e.g. a JAX init through convert.py."""
    args = parse_args(argv)
    dev = tool_device("profile_step", args.device)
    print(card_line(dev), flush=True)
    rng = np.random.default_rng(0)
    B, T_in, P, iters = args.batch, args.frames_in, args.pdfs, args.iters
    left = stride = 3
    T_out = (T_in - left + stride - 1) // stride

    model = build_model(args.xconfig)
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=P), P)
    den = DenominatorComputation(graph, leaky=1e-5, device=dev)
    structured = den._structured
    num_graph = supervision(B, T_out, max(256, T_out), P, rng)
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=stride, left_context=left)
    batch = {
        "features": torch.from_numpy(rng.normal(size=(B, T_in, 40))
                                     .astype(np.float32)).to(dev),
        "ivectors": torch.from_numpy(rng.normal(size=(B, 100))
                                     .astype(np.float32)).to(dev),
        "weights": torch.ones(B, device=dev),
    }

    def fresh(cfg):
        net, opt, scale = init_train_state(
            model, torch.Generator().manual_seed(0), cfg, dev)
        if state_dict is not None:
            net.load_state_dict(state_dict, strict=True)
        return net, [opt, scale], torch.Generator(device=dev).manual_seed(1)

    def bench_step(name, step_den, cfg=config):
        net, state, gen = fresh(cfg)
        step = make_train_step(model, net, step_den, num_graph,
                               ChainTrainingOpts(), cfg,
                               num_frames_out=T_out)

        def run():
            state[0], state[1], out = step(state[0], state[1], batch,
                                           generator=gen)
            return out.loss

        if structured is not None:
            structured.scan_used = None      # set by each den call
        res = measure(name, run, iters, dev)
        res["scan_used"] = (structured.scan_used if structured is not None
                            else None)
        return res

    def line(label, res, extra=""):
        dms = res["device_ms"]
        dev_txt = f"{dms:.2f} ms" if dms is not None else "not measured"
        print(f"{label}: {res['wall_ms']:7.2f} ms (device {dev_txt}){extra}",
              flush=True)

    results = {}
    results["full"] = bench_step("full", den)
    line("full step          ", results["full"])
    full = results["full"]["wall_ms"]

    results["no-den"] = bench_step("no-den", _ZeroDen())
    line("no-den             ", results["no-den"],
         f" (den in-context = {full - results['no-den']['wall_ms']:.2f})")

    saved_num = objective_mod.numerator_forward_backward
    objective_mod.numerator_forward_backward = _zero_num
    try:
        results["no-num"] = bench_step("no-num", den)
    finally:
        objective_mod.numerator_forward_backward = saved_num
    line("no-num             ", results["no-num"],
         f" (num in-context = {full - results['no-num']['wall_ms']:.2f})")

    saved_make = ts_mod.make_chain_objf_with_post
    ts_mod.make_chain_objf_with_post = _trivial_objf_factory
    try:
        results["no-chain"] = bench_step("no-chain", den)
    finally:
        ts_mod.make_chain_objf_with_post = saved_make
    line("no-chain           ", results["no-chain"],
         f" (chain in-context = "
         f"{full - results['no-chain']['wall_ms']:.2f})")

    # forward only, same geometry (no grad, no update)
    net, _, gen = fresh(config)
    chain_head = model.chain_output().name

    @torch.no_grad()
    def fwd_only():
        outs, _ = net(batch["features"], batch["ivectors"], train=True,
                      compute_dtype=torch.bfloat16, generator=gen)
        return torch.sum(subsample_output(outs[chain_head].float(), stride,
                                          left, T_out))

    results["fwd-only"] = {**measure("fwd-only", fwd_only, iters, dev),
                           "scan_used": None}
    del net
    line("fwd-only           ", results["fwd-only"])

    if args.lean:
        cfg2 = TrainConfig(learning_rate=1e-3, momentum=0.0,
                           frame_subsampling_factor=stride,
                           left_context=left, orthonormal_interval=0,
                           max_param_change=0.0)
        results["lean"] = bench_step("lean", den, cfg2)
        line("lean (no opt extras)", results["lean"],
             f" (optimizer extras = "
             f"{full - results['lean']['wall_ms']:.2f})")

    wall = {k: v["wall_ms"] for k, v in results.items()}
    attribution = {
        "den_fwd_bwd_ms": full - wall["no-den"],
        "num_fwd_bwd_ms": full - wall["no-num"],
        "chain_total_ms": full - wall["no-chain"],
        "network_fwd_bwd_opt_ms": wall["no-chain"],
        "network_fwd_ms": wall["fwd-only"]}
    print("\nattribution (in-context):")
    print(f"  den fwd-bwd      : {attribution['den_fwd_bwd_ms']:7.2f} ms")
    print(f"  num fwd-bwd      : {attribution['num_fwd_bwd_ms']:7.2f} ms")
    print(f"  chain total      : {attribution['chain_total_ms']:7.2f} ms")
    print(f"  network fwd+bwd+opt (no-chain): "
          f"{attribution['network_fwd_bwd_opt_ms']:7.2f} ms")
    print(f"  network fwd (fwd-only)        : "
          f"{attribution['network_fwd_ms']:7.2f} ms")
    print(json.dumps({
        "variants": results, "attribution": attribution,
        "batch": B, "frames_in": T_in, "frames_out": T_out, "pdfs": P,
        "iters": iters, "den_layout": den.layout_used,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "timer": "host + cuda_events" if dev.type == "cuda" else "host"}),
        flush=True)
    return results


if __name__ == "__main__":
    main()
