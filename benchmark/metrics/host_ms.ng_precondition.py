"""host_ms.ng_precondition: the median host milliseconds of the program's
`ng.precondition` span (training/train_step.py apply_natural_gradient) over
the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "ng.precondition")
