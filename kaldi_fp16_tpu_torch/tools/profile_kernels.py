"""Where the flagship recipe's train step spends its device time, with
and without NG-SGD: per-kernel times under torch.profiler.

    python -m kaldi_fp16_tpu_torch.tools.profile_kernels [--batch 128]
        [--frames-in 164] [--frames-out 50] [--xconfig configs/cnn_tdnn.xconfig]

The step is the Trainer's (make_train_step with a per-call numerator
graph) with configs/train_flagship.sh's training options: xent 0.1, loss
scaling, l2 5e-5, the orthonormal constraint, the default den (fused
scans on a card), NG-SGD on or off.  The batch is random (features,
ivectors, bench.py's linear supervision graph), from seed 0.  Three steps
are profiled, each after the same steps have run unprofiled once:

  ng_update   an NG step whose counters are due (t % 4 == 0): the Fisher
              factors are updated (batched eigensolves) and the grads
              preconditioned
  ng          an NG step between updates: preconditioning only
  no_ng       the same step without NG (direct and cut convs)

One JSON line each: the step's wall ms (host clock, synchronised), the
summed time of its kernels (`kernels_ms`: device time on a card, CPU
operator time with --device cpu, as `timed_on` says), their share of the
wall time (`busy_share`; the rest, the device waits for the host), that
time by
category (gemm, eigensolver, den scans, conv, elementwise, reduction,
copy, other) and the 15 largest kernels by name.  The first line is the
card's name and power limit as nvidia-smi gives them.  The profiler's
own cost per launch inflates the wall time somewhat.  Needs a card unless given
--device cpu (then the profile holds CPU operator times only).

A tool of the port's own (tools/profile_step.py's twin is
tools.profile_step, the in-context ablation of bench.py's step).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.tools._common import card_line, tool_device
from kaldi_fp16_tpu_torch.tools.profile_step import supervision
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from kaldi_fp16_tpu_torch.utils.profiling import kernel_times

ROOT = Path(__file__).resolve().parents[2]
CATEGORIES = (
    ("eigensolver", r"syev|rotate_batch|cusolver|jacobi|sytrd|stedc"),
    ("den_scan", r"fwd_product|bwd_product|scan_|den_"),
    ("conv", r"conv|implicit_gemm|cudnn|xmma_fprop|xmma_dgrad|xmma_wgrad"),
    ("gemm", r"gemm|cutlass|sm90_xmma|ampere_|sm80_|cublas"),
    ("copy", r"cat|copy|Memcpy|memcpy|Memset|pad|index"),
    ("reduction", r"reduce|Reduce|norm|softmax"),
    ("elementwise", r"elementwise|Elementwise|vectorized"),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=164)
    ap.add_argument("--frames-out", type=int, default=50)
    ap.add_argument("--left-context", type=int, default=3)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--xconfig", default=str(ROOT / "configs" /
                                             "cnn_tdnn.xconfig"))
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def report(name, wall, rows, dev):
    by_cat = {}
    for key, _, us in rows:
        by_cat[category(key)] = by_cat.get(category(key), 0.0) + us
    kernels_ms = sum(r[2] for r in rows) / 1e3
    print(json.dumps({
        "step": name, "wall_ms": wall, "timed_on": dev.type,
        "kernels_ms": kernels_ms, "busy_share": kernels_ms / wall,
        "by_category_ms": {k: v / 1e3 for k, v in
                           sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "kernels": [{"name": k[:90], "launches": n, "us": us}
                    for k, n, us in rows[:15]]}), flush=True)


def main(argv=None):
    args = parse_args(argv)
    dev = tool_device("profile_kernels", args.device)
    if dev.type == "cuda":
        print(card_line(dev), flush=True)
    rng = np.random.default_rng(0)
    B, T_in, P = args.batch, args.frames_in, args.pdfs
    model = build_model(args.xconfig)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_phone_lm_den_fst(num_pdfs=P), P), leaky=1e-5, device=dev)
    graph = supervision(B, args.frames_out, 2 * args.frames_out, P, rng)
    batch = {"features": torch.from_numpy(rng.normal(
                 size=(B, T_in, 40)).astype(np.float32)).to(dev),
             "ivectors": torch.from_numpy(rng.normal(
                 size=(B, 100)).astype(np.float32)).to(dev),
             "weights": torch.ones(B, device=dev)}
    opts = ChainTrainingOpts(l2_regularize=5e-5, xent_regularize=0.1)
    for natural_gradient in (True, False):
        config = TrainConfig(learning_rate=1e-4, xent_regularize=0.1,
                             use_loss_scaling=True,
                             natural_gradient=natural_gradient,
                             left_context=args.left_context)
        net, opt, scale = init_train_state(
            model, torch.Generator().manual_seed(0), config, dev)
        step = make_train_step(model, net, den, None, opts, config,
                               num_frames_out=args.frames_out)
        gen = torch.Generator(device=dev).manual_seed(1)
        state = [opt, scale]

        def run():
            state[0], state[1], _ = step(state[0], state[1], batch,
                                         generator=gen, num_graph=graph,
                                         left_context=args.left_context)

        if natural_gradient:
            # counters 0..4: update, three plain NG steps, update
            run()
            report("ng", *kernel_times(run, dev), dev)
            run()
            run()
            report("ng_update", *kernel_times(run, dev), dev)
        else:
            run()
            report("no_ng", *kernel_times(run, dev), dev)
        del net, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
