"""host_ms.den: the median host milliseconds of the program's `chain.den` span
(chain/objective.py, the den's forward-backward) over the window's steps
(harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "chain.den")
