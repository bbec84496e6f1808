"""csrdump: supervision FST stats for the first N examples
(ref: cmd/csrdump/main.go).

The twin of tools/csrdump.py on the port's EgsIterator and fst_to_csr:
the same flags and lines.  Host only: no device.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.csrdump EGS_PATTERN [--n 8]
"""

import argparse

from kaldi_fp16_tpu_torch.io.dataloader import EgsIterator
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.csrdump",
        description=__doc__.split("\n")[0])
    ap.add_argument("egs")
    ap.add_argument("--n", type=int, default=8)
    args = ap.parse_args(argv)

    for i, ex in enumerate(EgsIterator(args.egs)):
        if i >= args.n:
            break
        if ex.supervision is None or ex.supervision.fst is None:
            print(f"{ex.key}: no supervision FST")
            continue
        csr = fst_to_csr(ex.supervision.fst)
        print(f"{ex.key}: states={csr.num_states} arcs={csr.num_arcs} "
              f"start={csr.start_state} finals={len(csr.final_states)} "
              f"label_dim={csr.label_dim()} "
              f"frames_per_seq={ex.supervision.frames_per_seq} "
              f"weight={ex.supervision.weight}")


if __name__ == "__main__":
    main()
