"""profile_host on PyTorch: per-slice timing of the HOST side of the
production training loop at flagship dims.

The twin of tools/profile_host.py.  Slices per B-example batch:

  parse      ark bytes -> Example (the native parser when it loads) and
             validation, through the DataLoader's shuffled intake
  features   np.stack of features / ivectors / weights
  fst->csr   per-example supervision FST -> CSR
  numgraph   build_numerator_batch padding / stacking
  place      (--place) the Trainer's upload: pinned host buffers copied
             on its side stream (training/trainer.py upload_batch), then
             the wait and a sync of the card

`make_batch` whole is timed as a cross-check (~ features + fst->csr +
numgraph).  Everything but `place` runs on the host; `place` goes to the
card unless given --device.  Without --egs-dir, synthetic cegs at the
given geometry are written to a temporary directory first
(tools.make_synthetic_egs).

Usage:
  python -m kaldi_fp16_tpu_torch.tools.profile_host [--egs-dir DIR]
      [--batch 128] [--frames-in 150] [--frames-out 49] [--pdfs 3080]
      [--batches 8] [--place] [--device cpu]

Prints the card's name and power limit ("cpu" without --place), then the
JAX tool's keys as one JSON line; `main(argv)` returns them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.graph import build_numerator_batch
from kaldi_fp16_tpu_torch.io.batch import bucket_key, make_batch
from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
from kaldi_fp16_tpu_torch.tools._common import (
    card_line, device_arg, tool_device,
)
from kaldi_fp16_tpu_torch.training.trainer import upload_batch, wait_upload
from kaldi_fp16_tpu_torch.utils.profiling import sync_device

PLACE_WARM, PLACE_ITERS = 2, 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--egs-dir")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames-in", type=int, default=150)
    ap.add_argument("--frames-out", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--place", action="store_true",
                    help="also time the Trainer's upload of a batch to "
                         "the device")
    device_arg(ap, "--place")
    return ap.parse_args(argv)


def profile(args, egs_dir: str, dev) -> dict:
    cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs)
    pattern = os.path.join(egs_dir, "cegs.*.ark")
    per_batch = args.batch

    # -- parse + validate (example intake) ----------------------------------
    dl = DataLoader(pattern, cfg)
    t0 = time.perf_counter()
    examples = []
    for ex in dl._shuffled():
        examples.append(ex)
        if len(examples) >= per_batch * args.batches:
            break
    parse_s = time.perf_counter() - t0
    n = len(examples)
    if n < per_batch:
        raise SystemExit(f"--egs-dir yielded {n} examples < one --batch "
                         f"{per_batch}; point at a bigger set or lower "
                         f"--batch")
    buckets = {}
    for ex in examples:
        buckets.setdefault(bucket_key(ex), []).append(ex)
    groups = [v[i:i + per_batch] for v in buckets.values()
              for i in range(0, len(v) - per_batch + 1, per_batch)]
    if not groups:
        raise SystemExit(f"{n} examples never filled a homogeneous bucket "
                         f"of {per_batch}; lower --batch")

    # -- feature / weight stacking ------------------------------------------
    t0 = time.perf_counter()
    for g in groups:
        np.stack([ex.features for ex in g]).astype(np.float32)
        if g[0].ivector is not None:
            np.stack([ex.ivector[0] for ex in g]).astype(np.float32)
        np.asarray([ex.supervision.weight for ex in g], np.float32)
    feat_s = time.perf_counter() - t0

    # -- fst -> csr ----------------------------------------------------------
    t0 = time.perf_counter()
    csrs_by_g = [[fst_to_csr(ex.supervision.fst) for ex in g] for g in groups]
    csr_s = time.perf_counter() - t0

    # -- numerator graph batch -----------------------------------------------
    t0 = time.perf_counter()
    for csrs in csrs_by_g:
        build_numerator_batch(csrs, max_states=cfg.max_fst_states,
                              max_arcs=cfg.max_fst_arcs)
    num_s = time.perf_counter() - t0

    # -- whole make_batch (cross-check) --------------------------------------
    t0 = time.perf_counter()
    for g in groups:
        make_batch(g, max_fst_states=cfg.max_fst_states,
                   max_fst_arcs=cfg.max_fst_arcs)
    make_s = time.perf_counter() - t0

    nb = len(groups)
    audio_sec_per_batch = per_batch * args.frames_in / 100.0
    rows = {
        "examples": n, "batches_profiled": nb, "batch": per_batch,
        "reader": dl.readers,
        "parse_validate_ms_per_batch": parse_s / (n / per_batch) * 1e3,
        "feature_stack_ms_per_batch": feat_s / nb * 1e3,
        "fst_to_csr_ms_per_batch": csr_s / nb * 1e3,
        "num_graph_ms_per_batch": num_s / nb * 1e3,
        "make_batch_total_ms_per_batch": make_s / nb * 1e3,
        "host_total_ms_per_batch": (parse_s / (n / per_batch)
                                    + make_s / nb) * 1e3,
        "audio_sec_per_batch": audio_sec_per_batch,
    }
    rows["host_only_audio_sec_per_s"] = (
        audio_sec_per_batch / (rows["host_total_ms_per_batch"] / 1e3))

    if args.place:
        b = make_batch(groups[0], max_fst_states=cfg.max_fst_states,
                       max_fst_arcs=cfg.max_fst_arcs)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def place():
            wait_upload(upload_batch(b, dev, stream), dev, stream)
            sync_device(dev)

        for _ in range(PLACE_WARM):
            place()
        t0 = time.perf_counter()
        for _ in range(PLACE_ITERS):
            place()
        rows["place_sync_ms_per_batch"] = ((time.perf_counter() - t0)
                                           / PLACE_ITERS * 1e3)
        rows["place_device"] = (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")
    return rows


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = (tool_device("profile_host", args.device) if args.place
           else torch.device("cpu"))
    print(card_line(dev), flush=True)
    with contextlib.ExitStack() as stack:
        egs_dir = args.egs_dir
        if egs_dir is None:
            egs_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="egs_prof_"))
            with contextlib.redirect_stdout(io.StringIO()):
                make_synthetic_egs.main([
                    egs_dir, "--files", "2", "--per-file",
                    str(args.batch * (args.batches // 2 + 1)),
                    "--pdfs", str(args.pdfs), "--frames-in",
                    str(args.frames_in), "--frames-out",
                    str(args.frames_out)])
        rows = profile(args, egs_dir, dev)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
