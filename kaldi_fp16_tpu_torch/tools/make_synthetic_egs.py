"""Generate synthetic cegs ark files + a den.fst for smoke tests and
benchmarks (stands in for the 2600h dataset; ref format: SURVEY.md §2.1).

The twin of tools/make_synthetic_egs.py on the port's own writers
(kaldi_fp16_tpu_torch/io): the same flags, and for one seed the same
bytes (tests/test_torch_egs_io.py).

Usage: python -m kaldi_fp16_tpu_torch.tools.make_synthetic_egs OUTDIR
           [--files 2] [--per-file 16] [--pdfs 48] [--frames-in 48]
           [--frames-out 15] [--feat-dim 40] [--ivector-dim 100]
           [--den-states 32] [--den-topology random|phone-lm] [--seed 0]
"""

import argparse
import os

import numpy as np

from kaldi_fp16_tpu_torch.chain.graph import (
    make_phone_lm_den_fst, make_simple_den_fst,
)
from kaldi_fp16_tpu_torch.io.egs import (
    Example, Index, IoBlock, Supervision, write_ark,
)
from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState, write_fst_file


def make_example(rng, key, args, left):
    stride = args.frames_in // args.frames_out if args.frames_out else 3
    pdfs = rng.integers(1, args.pdfs + 1, size=args.frames_out)
    feats = rng.normal(size=(args.frames_in, args.feat_dim)).astype(np.float32) * 0.3
    for i, pdf in enumerate(pdfs):
        t0 = left + i * stride
        feats[max(0, t0 - 1): t0 + 2, int(pdf) % args.feat_dim] += 2.0

    states = [FstState() for _ in range(args.frames_out + 1)]
    for i, pdf in enumerate(pdfs):
        states[i].arcs.append(FstArc(int(pdf), 0.0, i + 1))
        alt = int(rng.integers(1, args.pdfs + 1))
        if alt != pdf:
            states[i].arcs.append(FstArc(alt, 2.0, i + 1))
    states[-1].final = 0.0

    sup = Supervision(
        name="output", weight=1.0, num_sequences=1,
        frames_per_seq=args.frames_out, label_dim=args.pdfs, end2end=False,
        fst=Fst(start=0, states=states),
        indexes=[Index(0, i * stride, 0) for i in range(args.frames_out)],
        deriv_weights=np.ones(args.frames_out, dtype=np.float32))
    return Example(
        key=key,
        inputs=[
            IoBlock("input", [Index(0, t - left, 0) for t in range(args.frames_in)],
                    feats, "CM"),
            IoBlock("ivector", [Index(0, 0, 0)],
                    rng.normal(size=(1, args.ivector_dim)).astype(np.float32),
                    "CM2"),
        ],
        supervision=sup)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--files", type=int, default=2)
    ap.add_argument("--per-file", type=int, default=16)
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--frames-in", type=int, default=48)
    ap.add_argument("--frames-out", type=int, default=15)
    ap.add_argument("--feat-dim", type=int, default=40)
    ap.add_argument("--ivector-dim", type=int, default=100)
    ap.add_argument("--den-states", type=int, default=32)
    ap.add_argument("--den-topology", default="random",
                    choices=["random", "phone-lm"],
                    help="phone-lm = realistic den.fst structure (routes "
                         "to the structured denominator kernels)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    left = 3
    # supervision frame i reads input row left + i*stride — the last one
    # must exist (a too-short frames_in silently misaligns training by a
    # frame via slice clamping)
    stride = args.frames_in // args.frames_out if args.frames_out else 3
    need = left + (args.frames_out - 1) * stride + 1
    if args.frames_in < need:
        raise SystemExit(f"--frames-in {args.frames_in} < {need} required "
                         f"for left={left}, frames_out={args.frames_out}, "
                         f"stride={stride}")
    total = 0
    for f in range(args.files):
        exs = [make_example(rng, f"utt-{f}-{i:04d}", args, left)
               for i in range(args.per_file)]
        path = os.path.join(args.outdir, f"cegs.{f + 1}.ark")
        write_ark(path, exs)
        total += len(exs)
        print(f"wrote {path}: {len(exs)} examples")

    if args.den_topology == "phone-lm":
        den = make_phone_lm_den_fst(
            num_pdfs=args.pdfs, num_phones=max(2, args.den_states // 2),
            states_per_phone=2,
            # production branching is 28 (7052-state den.fst has ~113K
            # arcs = ~16 arcs/state); small dens keep the old <=8 cap
            branching=min(28, max(2, args.den_states // 4)), seed=args.seed)
    else:
        den = make_simple_den_fst(num_pdfs=args.pdfs,
                                  num_states=args.den_states,
                                  seed=args.seed, arcs_per_state=4)
    den_path = os.path.join(args.outdir, "den.fst")
    write_fst_file(den_path, den, fmt="vector")
    print(f"wrote {den_path}: {den.num_states} states, {den.num_arcs} arcs")
    print(f"total: {total} examples, label_dim={args.pdfs}")


if __name__ == "__main__":
    main()
