"""host_ms.numerator: the median host milliseconds of the program's
`chain.numerator` span (chain/objective.py, the numerator's forward-
backward) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "chain.numerator")
