"""host_ms.place_batch: the median host milliseconds of the program's
`trainer.place_batch` span (training/trainer.py place_batch: a batch's
upload) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "trainer.place_batch")
