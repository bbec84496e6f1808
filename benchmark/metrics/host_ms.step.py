"""host_ms.step: the median host milliseconds of the program's `train_step`
span (training/train_step.py, the step's body: the host's whole step) over
the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "train_step")
