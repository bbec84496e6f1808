"""profile_latdecode on PyTorch: end-to-end phase attribution of the
HCLG lattice decode.

The twin of tools/profile_latdecode.py.  decodebench --lattice measures
the total only; this times DeviceLatticeDecoder.decode_batch's phases in
place, through its `mark` hook (utils.profiling.PhaseClock: a sync of the
card ends each phase, so the phases sum to the whole decode):

  scans         the alpha / beta scans and the packed keep-masks
                (`kernels_s`, the JAX tool's name)
  compaction    torch.nonzero over the mask with its count sync
                (`compact_sync_s`) and the copies of the kept bytes and
                their indices to the host (`compact_s` holds both;
                `kept_bytes` the nonzero bytes)
  assembly      the host's lattice assembly, both loops
                (`host_assembly_s`; the JAX tool's residual, the unmarked
                total less scans and compaction, is
                `host_assembly_s(resid)`)
  gather        the kept arcs' acoustic costs gathered on the card and
                copied back (`gather_s`)

One warm decode first, then the instrumented decode, then one decode
without marks (`total_s`, the decode as callers run it).  The graph is
decodebench's synth_hclg_graph, the loglikes randn from seed 1.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.profile_latdecode [--states 100000]
      [--pdfs 2048] [--batch 64] [--frames 300] [--transfer compact]
      [--beam 4.0] [--device cpu]

Prints the card's name and power limit, then one JSON line with the JAX
tool's keys; `main(argv)` returns it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.decode.device_viterbi import DeviceLatticeDecoder
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.tools.decodebench import synth_hclg_graph
from kaldi_fp16_tpu_torch.utils.profiling import PhaseClock, sync_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--states", type=int, default=100000)
    ap.add_argument("--pdfs", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--transfer", default="compact",
                    choices=["auto", "dense", "compact"])
    ap.add_argument("--beam", type=float, default=4.0)
    device_arg(ap, "the decode")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("profile_latdecode", args.device)
    print(card_line(dev), flush=True)
    graph = synth_hclg_graph(args.states, args.pdfs)
    dec = DeviceLatticeDecoder(graph, acoustic_scale=1.0,
                               lattice_beam=args.beam,
                               transfer=args.transfer, device=dev)
    B, T, P = args.batch, args.frames, args.pdfs
    gen = torch.Generator(device=dev).manual_seed(1)
    ll = torch.randn((B, T, P), generator=gen, device=dev)

    dec.decode_batch(ll)                      # warm everything once
    clock = PhaseClock(dev).start()
    lats = dec.decode_batch(ll, mark=clock)
    ph = clock.seconds
    sync_device(dev)
    t0 = time.perf_counter()
    dec.decode_batch(ll)
    sync_device(dev)
    t_total = time.perf_counter() - t0

    result = {
        "kernels_s": ph.get("scans", 0.0),
        "compact_s": ph.get("compact_sync", 0.0) + ph.get("compact", 0.0),
        "compact_sync_s": ph.get("compact_sync", 0.0),
        "gather_s": ph.get("gather", 0.0),
        "host_assembly_s": ph.get("assembly", 0.0),
        "phases_sum_s": sum(ph.values()),
        "total_s": t_total,
        # the JAX tool's residual: the unmarked total less scans and
        # compaction (assembly and gather, with the marks' syncs left out)
        "host_assembly_s(resid)": t_total - ph.get("scans", 0.0)
        - ph.get("compact_sync", 0.0) - ph.get("compact", 0.0),
        "kept_bytes": dec.last_kept_bytes,
        "kept_arcs": int(sum(len(l.arcs.src) for l in lats)),
        "mean_arcs": float(np.mean([len(l.arcs.src) for l in lats])),
        "transfer": dec.last_transfer,
        "config": {"S": graph.num_states, "B": B, "T": T, "P": P,
                   "beam": args.beam},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
