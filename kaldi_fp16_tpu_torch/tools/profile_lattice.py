"""profile_lattice on PyTorch: where the tree-layout lattice frame spends
its time.

The twin of tools/profile_lattice.py.  On decodebench's HCLG-shaped graph
and the tree-ELL tables of width 128 (`_Tree` with its OUT tables), it
times each piece of the lattice decode's per-frame work over --frames
frames of random scores and loglikes (seed 0), one warm pass first:

  min_step only          the min-plus reduction (`_Tree.alpha_step`)
  keep-mask gathers      alpha[src] + cost + beta[dst] over the A arcs and
                         the comparison with the threshold (per arc, as
                         the segment and ELL layouts test)
  packbits               packing a [A, B] keep-mask into bytes alone
  full bwd_frame         beta's min step on the OUT tables, the per-arc
                         keep-mask and its packing
  FUSED bwd_frame        `_Tree.beta_step`: the keep test in the OUT
                         tables' level-1 slots, one alpha gather per row

in ms per frame: CUDA events around the frames on a card, the host clock
with --device cpu.

Usage: python -m kaldi_fp16_tpu_torch.tools.profile_lattice
       [--states 100000] [--pdfs 3080] [--batch 8] [--frames 32]
       [--device cpu]

Prints the card's name and power limit, then the JAX tool's lines;
`main(argv)` returns the numbers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from kaldi_fp16_tpu_torch.decode.device_viterbi import (
    ArcGraph, _mask_buffers, _Tree,
)
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.tools.decodebench import synth_hclg_graph
from kaldi_fp16_tpu_torch.tools.profile_tree import (
    frames_of, line, per_frame_ms,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--states", type=int, default=100000)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32)
    device_arg(ap, "the frame")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("profile_lattice", args.device)
    print(card_line(dev), flush=True)
    S, P, B, T = args.states, args.pdfs, args.batch, args.frames
    graph = synth_hclg_graph(S, P)
    a = ArcGraph.from_graph(graph)
    S = a.num_states
    A = len(a.src)
    print(f"graph: S={S} A={A} P={P} B={B} T={T}")

    g = _Tree(a, 1.0, dev, lattice=True)
    rng = np.random.default_rng(0)
    alpha0 = torch.from_numpy(rng.normal(size=(S, B)).astype(np.float32)) \
        .to(dev)
    ll = torch.from_numpy(rng.normal(size=(T, P, B)).astype(np.float32)) \
        .to(dev)
    thr = torch.zeros((B,), device=dev)
    src_rows, dst_rows, pdf_rows = g.rows(B)
    gcost = g.gcost[:, None]
    # the per-arc mask (A bits) and the slot-order one (the OUT tables'
    # level-1 slots)
    arc_packed = torch.empty((-(-A // 8), B), dtype=torch.uint8, device=dev)
    arc_keep = torch.zeros((8 * arc_packed.shape[0], B), dtype=torch.bool,
                           device=dev)
    slot_packed, slot_keep = _mask_buffers(g, 1, B, dev)
    out = {"states": S, "arcs": A, "batch": B, "frames": T,
           "slots": g.nbits}

    # 1. min_step only (the alpha/beta reduction)
    out["min_step_ms"] = line("min_step only", per_frame_ms(frames_of(
        lambda c, ll_t: g.alpha_step(c, ll_t, torch.empty_like(c)),
        alpha0, ll), T, dev), 44)

    # 2. arc keep-mask gathers only (alpha[src] + ll[pdf] + beta[dst])
    def mask_only(c, ll_t):
        tot = torch.take(c, src_rows) + gcost
        tot += torch.take(ll_t, pdf_rows)
        tot += torch.take(c, dst_rows)
        (tot <= thr).sum(0)
        return c
    out["keep_mask_gathers_ms"] = line(
        "keep-mask gathers (3xA rows) + cmp",
        per_frame_ms(frames_of(mask_only, alpha0, ll), T, dev), 44)

    # 3. packing a [A, B] bool alone
    def pack_only(c, ll_t):
        torch.gt(c[:1] + ll_t[:1], 0, out=arc_keep[:1])
        g.pack(arc_keep, arc_packed)
        return c
    out["packbits_ms"] = line(
        "packbits [A, B] alone",
        per_frame_ms(frames_of(pack_only, alpha0, ll), T, dev), 44)

    # 4. beta's min step + the per-arc mask + packing
    def full(c, ll_t):
        beta = g.fout.min_step(c, ll_t, g.scale)
        tot = torch.take(c, src_rows) + gcost
        tot += torch.take(ll_t, pdf_rows)
        tot += torch.take(c, dst_rows)
        torch.le(tot, thr, out=arc_keep[:A])
        g.pack(arc_keep, arc_packed)
        return beta
    out["full_bwd_frame_ms"] = line(
        "full bwd_frame (min+mask+packbits)",
        per_frame_ms(frames_of(full, alpha0, ll), T, dev), 44)

    # 5. the fused frame: the keep test in the OUT tables' slot order
    out["fused_bwd_frame_ms"] = line(
        "FUSED bwd_frame (slot-order mask)",
        per_frame_ms(frames_of(
            lambda c, ll_t: g.beta_step(c, c, ll_t, thr, slot_keep,
                                        slot_packed[0]),
            alpha0, ll), T, dev), 44)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


if __name__ == "__main__":
    main()
