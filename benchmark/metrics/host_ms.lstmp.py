"""host_ms.lstmp: the median host milliseconds of the program's
`network.lstmp` span (models/network.py, one fast-lstmp layer's forward:
its input product, the recurrence's launch, the projection) over the
window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "network.lstmp")
