"""host_ms.update: the median host milliseconds of the program's
`train_step.update` span (training/train_step.py, from the gradient norm to
the step's end: BatchNorm select, SGD, the parameter copy, the orthonormal
constraint) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "train_step.update")
