"""profile_tree on PyTorch: where the tree-ELL Viterbi step spends its time.

The twin of tools/profile_tree.py.  It builds the tree-ELL tables of
decodebench's HCLG-shaped graph (`TreeEllGraph`, rows of at most
--max-width slots), prints their level-1 buckets and reduce levels, and
times each piece of the per-frame step over --frames frames of random
scores and loglikes (seed 0), one warm pass first:

  L1 gathers+max        the level-1 buckets' gathers and axis max only
  min_step              the min-plus step with its reduce levels
                        (`_Tree.alpha_step`, the lattice's alpha)
  max_step              the Viterbi step with argmax and arc tracking,
                        each frame's backpointers written to one buffer
  max_step + bp stack   `_viterbi_frames`, the [T, S, B] backpointers
                        kept (the plain Viterbi decode's forward)

in ms per frame: CUDA events around the frames on a card (the frames run
back to back, as in a decode), the host clock with --device cpu.

Usage: python -m kaldi_fp16_tpu_torch.tools.profile_tree [--states 100000]
       [--pdfs 3080] [--batch 16] [--frames 64] [--max-width 128]
       [--device cpu]

Prints the card's name and power limit, then the JAX tool's lines;
`main(argv)` returns the numbers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.decode.device_viterbi import (
    ArcGraph, _Tree, _viterbi_frames,
)
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.tools.decodebench import synth_hclg_graph


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--states", type=int, default=100000)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--max-width", type=int, default=128)
    device_arg(ap, "the step")
    return ap.parse_args(argv)


def per_frame_ms(run, frames: int, dev) -> float:
    """ms per frame of run() (all the frames), after one warm run."""
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / frames
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3 / frames


def line(name, ms, width=40):
    print(f"{name:{width}s} {ms:8.3f} ms/frame", flush=True)
    return ms


def frames_of(step, carry, ll):
    """run() that carries `carry` through step(c, ll_t) over ll's frames."""
    def run():
        c = carry
        for t in range(ll.shape[0]):
            c = step(c, ll[t])
        return c
    return run


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("profile_tree", args.device)
    print(card_line(dev), flush=True)
    S, P, B, T = args.states, args.pdfs, args.batch, args.frames
    graph = synth_hclg_graph(S, P)
    arcs = ArcGraph.from_graph(graph)
    S = graph.num_states
    A = len(arcs.src)
    print(f"graph: S={S} A={A} P={P} B={B} T={T}")

    t0 = time.perf_counter()
    g = _Tree(arcs, 1.0, dev, args.max_width)
    build_s = time.perf_counter() - t0
    print(f"tree build: {build_s:.2f}s")
    tab = g.fin
    l1_shapes = [tuple(x.shape) for x in tab.src]
    slots_l1 = sum(int(np.prod(s)) for s in l1_shapes)
    print(f"level-1 buckets: {l1_shapes} ({slots_l1} slots, "
          f"{slots_l1 / max(A, 1):.2f}x arcs)")
    for i, lvl in enumerate(tab.levels):
        print(f"reduce level {i + 2}: {[tuple(e.shape) for e in lvl]}")

    rng = np.random.default_rng(0)
    score0 = torch.from_numpy(rng.normal(size=(S, B)).astype(np.float32)) \
        .to(dev)
    ll = torch.from_numpy(rng.normal(size=(T, P, B)).astype(np.float32)) \
        .to(dev)
    src_rows, pdf_rows, _, _ = tab.rows(B)

    # 1. gathers only: both operand gathers, summed, reduced by max
    def gathers_only(score, ll_t):
        vals = torch.empty((tab.sizes[0], B), device=dev)
        r0 = 0
        for sr, pr, w in zip(src_rows, pdf_rows, tab.w):
            r1 = r0 + sr.shape[0]
            cand = torch.take(score, sr).add_(w)
            cand += torch.take(ll_t, pr)
            torch.amax(cand, 1, out=vals[r0:r1])
            r0 = r1
        return torch.maximum(vals[:S], score)     # keep shape [S, B]

    out = {"states": S, "arcs": A, "batch": B, "frames": T,
           "max_width": args.max_width,
           "level1_slots": slots_l1, "levels": 1 + len(tab.levels),
           "tree_build_s": build_s}
    out["l1_gathers_max_ms"] = line(
        "L1 gathers+max (no levels, no argmax)",
        per_frame_ms(frames_of(gathers_only, score0, ll), T, dev))

    # 2. min_step (full reduction levels, no arc tracking)
    def min_step(score, ll_t):
        return g.alpha_step(score, ll_t, torch.empty_like(score))
    out["min_step_ms"] = line(
        "min_step (levels, no argmax)",
        per_frame_ms(frames_of(min_step, score0, ll), T, dev))

    # 3. max_step with argmax and arc tracking, each frame's bp dropped
    bp = torch.empty((S, B), dtype=torch.int32, device=dev)
    out["max_step_ms"] = line(
        "max_step (argmax+arc track, bp dropped)",
        per_frame_ms(frames_of(lambda s, l: g.viterbi_step(s, l, bp),
                               score0, ll), T, dev))

    # 4. max_step with the [T, S, B] bp history (_viterbi_frames)
    score_start = g.start_scores(B)
    out["max_step_bp_stack_ms"] = line(
        "max_step + [T,S,B] bp stack",
        per_frame_ms(lambda: _viterbi_frames(g, score_start, ll), T, dev))
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


if __name__ == "__main__":
    main()
