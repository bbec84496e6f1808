"""scalebench on PyTorch: data-parallel weak scaling, and the
data-parallel step held to one process.

The twin of tools/scalebench.py.  It runs the data-parallel train step
(parallel/'s DataGroup) at 1, 2, 4 and 8 ranks with a CONSTANT
batch per rank and reports the step time and the weak-scaling
efficiency (world 1's step time over world n's; ideal 1.0), and at each
world it holds the ranks' first two steps against one process on the
same global batch at tests/test_parallel.py's bars (loss rtol 1e-5,
parameters rtol 2e-5 / atol 1e-6) and the ranks' parameters to each
other bit for bit.  The model is the JAX tool's (a 128-wide TDNN-F stack,
fp32), its den a 64-state random graph, the supervision bench.py's
linear chains.

On a card (the default) the ranks share the host's cards: one card
each over NCCL up to the cards' count, and above it gloo ranks on card
r mod the cards, as chip_smoke's data_parallel phase runs two ranks on
one card.  Those worlds check the collectives' program on the card;
their times are not a scaling figure.  `--real` leaves them out: NCCL
only, at the worlds the cards allow (on one card, world 1 alone, and the
tool says so).  `--device cpu` runs gloo ranks on the CPU, the JAX tool's
virtual CPU mesh: a fidelity check, not a card's scaling.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.scalebench [--per-device-batch 4]
      [--frames 48] [--pdfs 48] [--iters 5] [--worlds 1,2,4,8] [--real]
      [--device cpu]

The first line is the card's name and power limit ("cpu" on the CPU).
`main(argv)` returns the final JSON line's dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.graph import make_simple_den_fst
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import (
    Setup, run_on_ranks, run_setup,
)
from kaldi_fp16_tpu_torch.tools.profile_step import supervision

LOSS = dict(rtol=1e-5)                   # tests/test_parallel.py's bars
PARAMS = dict(rtol=2e-5, atol=1e-6)
CHECK_STEPS = 2
JOIN_SECONDS = 600
STRIDE = LEFT = 3


def xconfig(pdfs: int) -> str:
    """The JAX tool's model (tools/scalebench.py:83-90)."""
    return f"""\
input name=ivector dim=100
input name=input dim=40
relu-batchnorm-layer name=tdnn1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=128
tdnnf-layer name=tdnnf2 dim=128 bottleneck-dim=32 time-stride=3
tdnnf-layer name=tdnnf3 dim=128 bottleneck-dim=32 time-stride=3
prefinal-layer name=prefinal-chain big-dim=128 small-dim=64
output-layer name=output include-log-softmax=false dim={pdfs}
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--worlds", default="1,2,4,8",
                    help="world sizes to run (those above the cards are "
                         "left out with --real)")
    ap.add_argument("--real", action="store_true",
                    help="on cards, NCCL only: one rank per card, the "
                         "worlds above the cards' count left out")
    device_arg(ap, "the ranks")
    return ap.parse_args(argv)


def world_backends(worlds, device, real: bool):
    """(world, backend) per world size to run on `device`: gloo on the
    CPU; on cards NCCL (None, the default) up to the cards' count and
    gloo ranks sharing the cards above it, or, with `real`, those left
    out."""
    if device.type != "cuda":
        return [(n, "gloo") for n in worlds]
    cards = torch.cuda.device_count()
    if real:
        worlds = [n for n in worlds if n <= cards]
        if cards == 1:
            print("scalebench --real: one card, so world 1 only; weak "
                  "scaling needs more cards", file=sys.stderr)
    return [(n, None if n <= cards else "gloo") for n in worlds]


def make_setup(world: int, args, steps: int) -> Setup:
    """The global batch of `world` ranks, per_device_batch rows each, from
    seed `world` (each world its own data, as the JAX tool draws it)."""
    rng = np.random.default_rng(world)
    B, T_in, P = args.per_device_batch * world, args.frames, args.pdfs
    T_out = (T_in - LEFT + STRIDE - 1) // STRIDE
    return Setup(
        xconfig=xconfig(P),
        den_fst=make_simple_den_fst(num_pdfs=P, num_states=64, seed=1,
                                    arcs_per_state=4),
        num_pdfs=P,
        batch={"features": rng.normal(size=(B, T_in, 40)).astype(np.float32),
               "ivectors": rng.normal(size=(B, 100)).astype(np.float32),
               "weights": np.ones(B, np.float32)},
        num_graph=supervision(B, T_out, 2 * T_out, P, rng),
        config=dict(learning_rate=1e-3, momentum=0.9,
                    frame_subsampling_factor=STRIDE, left_context=LEFT,
                    compute_dtype="float32"),
        num_frames_out=T_out, steps=steps)


def check_against_one_process(ranks, single, world):
    """The ranks' first CHECK_STEPS steps against one process at
    tests/test_parallel.py's bars; the ranks bit-identical."""
    for r in ranks:
        for got, ref in zip(r["outputs"], single["outputs"]):
            np.testing.assert_allclose(got["loss"], ref["loss"], **LOSS,
                                       err_msg=f"world {world}: loss")
    for k, v in single["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k], v, **PARAMS,
                                   err_msg=f"world {world}: {k}")
        for r in ranks[1:]:
            if not np.array_equal(r["params"][k], ranks[0]["params"][k]):
                raise AssertionError(f"world {world}: {k} differs between "
                                     f"the ranks")


def world_point(world: int, args, device, backend=None) -> dict:
    """One world size: the check against one process, then 1 + --iters
    steps timed on every rank (the first left out).  Returns the point."""
    check = make_setup(world, args, CHECK_STEPS)
    bench = dataclasses.replace(check, steps=1 + args.iters)
    single = run_setup(check, device=device)
    ranks = run_on_ranks([check, bench], world, JOIN_SECONDS, device,
                         backend, rank0_here=True)
    check_against_one_process([r[0] for r in ranks], single, world)
    step_s = max(float(np.mean(r[1]["step_seconds"][1:])) for r in ranks)
    return {"devices": world, "global_batch": check.batch["weights"].size,
            "step_ms": step_s * 1e3, "loss": ranks[0][1]["outputs"][-1]["loss"],
            "backend": ranks[0][1]["backend"], "device": ranks[0][1]["device"],
            "checked_vs_one_process": True}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = tool_device("scalebench", args.device)
    print(card_line(device), flush=True)
    plan = world_backends([int(w) for w in args.worlds.split(",")], device,
                          args.real)
    platform = "gpu" if device.type == "cuda" else "cpu"
    print(f"platform={platform} worlds={[n for n, _ in plan]}", flush=True)
    points, base = [], None
    for n, backend in plan:
        point = world_point(n, args, device, backend)
        base = base if base is not None else point["step_ms"]
        point["weak_scaling_efficiency"] = base / point["step_ms"]
        points.append(point)
        print(point, flush=True)
    result = {"metric": "dp_weak_scaling", "platform": platform,
              "per_device_batch": args.per_device_batch, "points": points}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
