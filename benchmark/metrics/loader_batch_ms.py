"""loader_batch_ms: the median host milliseconds of the program's
`loader.batch` span (io/dataloader.py DataLoader, on the producer's thread:
one batch's parse, shuffle, bucketing and assembly) over the window's steps
(harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "loader.batch")
