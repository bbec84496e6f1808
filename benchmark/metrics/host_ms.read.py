"""host_ms.read: the median host milliseconds of the program's
`train_step.read` span (training/train_step.py, the step's one device read
(the host waiting on the card)) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "train_step.read")
