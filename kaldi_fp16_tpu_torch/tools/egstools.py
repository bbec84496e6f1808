"""egstools: cegs ark Swiss-army knife (ref: cmd/egstools/main.go).

The twin of tools/egstools.py on the port's io copies: the same
subcommands, flags and stdout.  Host only: no device.

Subcommands:
  analyze ARK...        per-file structural stats (examples, frame sizes,
                        validity, FST sizes)
  dump ARK [-n N]       print the first N examples' metadata
  totext ARK            emit text rendering of every example
  verify ARK...         validate all examples, report skip reasons
  fst PATH              print FST structure (works on den.fst / supervision)
  compare ARK...        native C++ parser vs Python parser, field by field

Usage:
  python -m kaldi_fp16_tpu_torch.tools.egstools analyze|dump|totext|verify|
      fst|compare PATH... [-n 5] [--feat-dim 40] [--ivector-dim 100]
      [--label-dim 0]

verify exits 1 on an invalid example, fst on an unreadable file, compare
on a mismatch (2 without the native parser).
"""

import argparse
import collections
import sys

import numpy as np


def cmd_analyze(args):
    from kaldi_fp16_tpu_torch.io.dataloader import EgsIterator
    for path in args.paths:
        it = EgsIterator([path])
        frames = collections.Counter()
        fps = collections.Counter()
        fst_states = []
        fst_arcs = []
        count = 0
        for ex in it:
            count += 1
            if ex.features is not None:
                frames[ex.features.shape[0]] += 1
            fps[ex.supervision.frames_per_seq] += 1
            if ex.supervision.fst is not None:
                fst_states.append(ex.supervision.fst.num_states)
                fst_arcs.append(ex.supervision.fst.num_arcs)
        print(f"{path}: {count} examples")
        print(f"  input frame sizes: {dict(sorted(frames.items()))}")
        print(f"  frames_per_seq:    {dict(sorted(fps.items()))}")
        if fst_states:
            print(f"  supervision FST:   states avg={np.mean(fst_states):.1f} "
                  f"max={max(fst_states)}, arcs avg={np.mean(fst_arcs):.1f} "
                  f"max={max(fst_arcs)}")


def cmd_dump(args):
    from kaldi_fp16_tpu_torch.io.egs import read_examples
    for ex in read_examples(args.paths[0], limit=args.n):
        sup = ex.supervision
        feats = ex.features
        print(f"{ex.key}: input={feats.shape if feats is not None else None} "
              f"ivector={ex.ivector.shape if ex.ivector is not None else None} "
              f"weight={sup.weight} nseq={sup.num_sequences} "
              f"fps={sup.frames_per_seq} label_dim={sup.label_dim} "
              f"fst={sup.fst.num_states if sup.fst else 0}st/"
              f"{sup.fst.num_arcs if sup.fst else 0}arcs")


def cmd_totext(args):
    from kaldi_fp16_tpu_torch.io.egs import EgsReader, example_to_text
    with EgsReader(args.paths[0]) as r:
        for ex in r:
            print(example_to_text(ex))


def cmd_verify(args):
    from kaldi_fp16_tpu_torch.io.dataloader import EgsIterator
    total = valid = 0
    reasons = collections.Counter()
    for path in args.paths:
        for ex in EgsIterator([path]):
            total += 1
            ok, reason = ex.validate(feat_dim=args.feat_dim,
                                     ivector_dim=args.ivector_dim,
                                     label_dim=args.label_dim)
            if ok:
                valid += 1
            else:
                reasons[reason] += 1
    print(f"total={total} valid={valid} invalid={total - valid}")
    for r, c in reasons.most_common():
        print(f"  {c:6d}  {r}")
    sys.exit(0 if valid == total else 1)


def cmd_fst(args):
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    fst = read_fst_file(args.paths[0])
    if fst is None:
        print("unreadable FST")
        sys.exit(1)
    print(f"states={fst.num_states} arcs={fst.num_arcs} start={fst.start}")
    finals = [s for s, st in enumerate(fst.states) if st.is_final]
    print(f"final states: {len(finals)}"
          + (f" (first: {finals[:5]})" if finals else ""))
    labels = [a.label for st in fst.states for a in st.arcs]
    if labels:
        print(f"labels: min={min(labels)} max={max(labels)}")
    if args.n:
        for s, st in enumerate(fst.states[:args.n]):
            for a in st.arcs:
                print(f"  {s} -> {a.next_state} label={a.label} w={a.weight:.4f}")


def cmd_compare(args):
    """Native C++ parser vs pure-Python parser, field by field (the
    available parser oracle here; the reference compared against a live
    Kaldi install, cmd/egstools compare)."""
    from kaldi_fp16_tpu_torch.io.egs import EgsReader, example_to_text
    from kaldi_fp16_tpu_torch.io.native import NativeEgsReader, native_available
    if not native_available():
        print("native parser not built (make -C cpp); nothing to compare")
        sys.exit(2)
    import itertools
    mismatches = total = 0
    for path in args.paths:
        with EgsReader(path) as rp, NativeEgsReader(path) as rn:
            # zip_longest: a COUNT disagreement is exactly the kind of
            # parser divergence this oracle exists to catch
            for ep, en in itertools.zip_longest(rp, rn):
                total += 1
                if ep is None or en is None:
                    mismatches += 1
                    who = "python" if ep is None else "native"
                    print(f"MISMATCH: {who} reader ran out of examples first")
                    break
                key = (ep.key, ep.supervision.name,
                       [b.fmt for b in ep.inputs],
                       ep.supervision.deriv_weights_fmt)
                key_n = (en.key, en.supervision.name,
                         [b.fmt for b in en.inputs],
                         en.supervision.deriv_weights_fmt)
                if example_to_text(ep) != example_to_text(en) or key != key_n:
                    mismatches += 1
                    print(f"MISMATCH {ep.key}: {key} vs {key_n}")
    print(f"compared {total} examples: "
          f"{'all identical' if not mismatches else f'{mismatches} mismatches'}")
    sys.exit(1 if mismatches else 0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.egstools",
        description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["analyze", "dump", "totext", "verify",
                                    "fst", "compare"])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("-n", type=int, default=5)
    ap.add_argument("--feat-dim", type=int, default=40)
    ap.add_argument("--ivector-dim", type=int, default=100)
    ap.add_argument("--label-dim", type=int, default=0)
    args = ap.parse_args(argv)
    globals()[f"cmd_{args.cmd}"](args)


if __name__ == "__main__":
    main()
