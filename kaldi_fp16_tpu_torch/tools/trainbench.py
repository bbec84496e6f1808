"""trainbench on PyTorch: chain TRAINING throughput of the flagship
CNN-TDNN at production scale (den.fst 7052 states / 113K arcs / 3080
pdfs, 150-frame chunks), in audio-seconds per second per card (100
feature frames = 1 audio second).

The twin of tools/trainbench.py: bench.py's step (SGD with momentum, no
xent) through the port's make_train_step, with its flags.  The JSON line
keeps the JAX tool's keys, `vs_baseline` included: the rate over 105
audio-s/s, the rate the RTX 4090 reference implies (tools/trainbench.py's
docstring), not a TPU figure.  `--topology random` takes the blocked den
(on a card its posterior reduce is the segment_reduce kernel); phone-lm
the structured den (on a card the fused scans).  `--mode fast` and
`--bn-lowp` were revoked in the JAX package and are not ported (ROADMAP.md
queue 1 item 5): the tool exits 2.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.trainbench [--batch 32]
      [--frames 150] [--iters 10] [--natural-gradient] [--remat]
      [--no-grid] [--topology phone-lm|random] [--pdfs 3080]
      [--xconfig configs/cnn_tdnn.xconfig] [--device cpu]

On a card the steps are timed with CUDA events (one warm-up step, then
--iters steps back to back); `--device cpu` times the plain versions on
the host clock (`"timer": "host"`).  The first line is the card's name and
power limit.  `main(argv)` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.models.model import build_model
from kaldi_fp16_tpu_torch.tools._common import (
    DEN_ARCS, DEN_STATES, card_line, den_graph, device_arg, time_ms,
    tool_device,
)
from kaldi_fp16_tpu_torch.tools.chainbench import make_num_graph
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)

ROOT = Path(__file__).resolve().parents[2]
BASELINE = 105.0     # implied reference audio-sec/s (tools/trainbench.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=150)   # input frames
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--den-states", type=int, default=DEN_STATES)
    ap.add_argument("--den-arcs", type=int, default=DEN_ARCS)
    ap.add_argument("--num-arcs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--xconfig", default=str(ROOT / "configs" /
                                             "cnn_tdnn.xconfig"))
    ap.add_argument("--natural-gradient", action="store_true")
    ap.add_argument("--mode", default="exact", choices=["exact", "fast"],
                    help="fast: revoked, not ported (exits 2)")
    ap.add_argument("--no-grid", action="store_true",
                    help="run the post-CNN stack at the full input frame "
                         "rate (no frame-grid subsampling)")
    ap.add_argument("--remat", action="store_true",
                    help="torch.utils.checkpoint the network forward "
                         "(recompute activations in the backward)")
    ap.add_argument("--bn-lowp", action="store_true",
                    help="revoked, not ported (exits 2)")
    ap.add_argument("--topology", default="phone-lm",
                    choices=["phone-lm", "random"],
                    help="den graph: phone-lm (the structured den, as "
                         "bench.py) or random (the blocked den)")
    device_arg(ap, "the steps")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    for flag, revoked in (("--mode fast", args.mode == "fast"),
                          ("--bn-lowp", args.bn_lowp)):
        if revoked:
            print(f"trainbench: {flag} is not ported: it was revoked in the "
                  f"JAX package (ROADMAP.md queue 1 item 5)",
                  file=sys.stderr)
            raise SystemExit(2)
    dev = tool_device("trainbench", args.device)
    print(card_line(dev), flush=True)

    rng = np.random.default_rng(0)
    B, T_in, P = args.batch, args.frames, args.pdfs
    left = stride = 3
    T_out = (T_in - left + stride - 1) // stride
    model = build_model(args.xconfig)
    graph = den_graph(args.topology, P, args.den_states, args.den_arcs, rng)
    den = DenominatorComputation(graph, leaky=1e-5, device=dev)
    # a reachable linear chain of T_out arcs + parallel alternatives
    num_graph = make_num_graph(B, T_out, P, args.num_arcs, rng)
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=stride, left_context=left,
                         natural_gradient=args.natural_gradient,
                         remat=args.remat, grid_subsample=not args.no_grid)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, dev)
    step = make_train_step(model, net, den, num_graph, ChainTrainingOpts(),
                           config, num_frames_out=T_out)
    batch = {
        "features": torch.from_numpy(rng.normal(size=(B, T_in, 40))
                                     .astype(np.float32)).to(dev),
        "ivectors": torch.from_numpy(rng.normal(size=(B, 100))
                                     .astype(np.float32)).to(dev),
        "weights": torch.ones(B, device=dev),
    }
    gen = torch.Generator(device=dev).manual_seed(1)
    state = [opt, scale, None]

    def run():
        state[0], state[1], state[2] = step(state[0], state[1], batch,
                                            generator=gen)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ms = time_ms(run, args.iters, dev)
    out = state[2]
    audio_s = B * T_in / 100.0
    rate = audio_s / (ms / 1e3)
    structured = den._structured
    result = {
        "metric": "train_audio_sec_per_s_per_chip",
        "value": rate,
        "unit": "audio-sec/s/chip",
        "vs_baseline": rate / BASELINE,
        "detail": {"step_ms": ms, "batch": B, "frames_in": T_in,
                   "frames_out": T_out,
                   "natural_gradient": args.natural_gradient,
                   "den_mode": args.mode, "remat": args.remat,
                   "bn_lowp": args.bn_lowp,
                   "den_topology": args.topology,
                   "den_layout": den.layout_used,
                   "scan_used": structured.scan_used if structured else None,
                   "posterior_reduce": (None if structured
                                        else den.posterior_reduce),
                   "num_logprob": float(out.num_logprob),
                   "loss": float(out.loss),
                   "max_memory_allocated_bytes": (
                       torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None)},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "timer": "cuda_events" if dev.type == "cuda" else "host",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
