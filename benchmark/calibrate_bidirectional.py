"""Readings from which a bidirectional step cell's correctness limits are
set: calibrate_recurrent.py's readings for the `step_bidirectional`
driver (reference/tdnn_blstm.py), with the faults that reference has for
a BLSTM: no_reverse (the backward layers walked forward), right_edge (the
reverse walks started at the last supervised frame), bf16_c (the cell
state in bf16) and s1 (no decay scale).

  python benchmark/calibrate_bidirectional.py --workload tdnn_blstm.step \\
      --seeds 1,2,3,4 [--control-seeds 1]

One JSON line per seed; no timing.  Needs the cell's card.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import calibrate_recurrent as cal  # noqa: E402

FAULTS = ("no_reverse", "right_edge", "bf16_c", "s1")


def main(argv=None, device=None):
    cal.FAULTS = FAULTS
    return cal.main(argv, device)


if __name__ == "__main__":
    sys.exit(main())
