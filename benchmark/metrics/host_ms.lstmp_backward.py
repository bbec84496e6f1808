"""host_ms.lstmp_backward: the median host milliseconds of the program's
`lstmp.backward` span (ops/lstmp.py, the recurrence's backward on
autograd's thread: its launch and the weights' gradient products) over
the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "lstmp.backward")
