"""nscheck: batch metadata sanity print: NumSequences, FramesPerSeq per
sequence, weights (ref: cmd/nscheck/main.go).

The twin of tools/nscheck.py on the port's DataLoader: the same flags
and lines.  Host only: no device.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.nscheck EGS_PATTERN [--batch 8]
      [--max-batches 4]
"""

import argparse

from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.nscheck",
        description=__doc__.split("\n")[0])
    ap.add_argument("egs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=4)
    args = ap.parse_args(argv)

    dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch))
    for i, b in enumerate(dl):
        if i >= args.max_batches:
            break
        print(f"batch {i}: B={len(b.keys)} T_in={b.features.shape[1]} "
              f"frames_per_seq={b.frames_per_seq} "
              f"left_context={b.left_context}")
        for k, w in zip(b.keys, b.weights):
            print(f"  {k}: weight={w}")
    print(dl.summary())


if __name__ == "__main__":
    main()
