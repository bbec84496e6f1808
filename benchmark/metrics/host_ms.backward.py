"""host_ms.backward: the median host milliseconds of the program's
`train_step.backward` span (training/train_step.py, from the xent term
through the loss-scale update: backward, grads, unscale, all-reduce,
finiteness) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "train_step.backward")
