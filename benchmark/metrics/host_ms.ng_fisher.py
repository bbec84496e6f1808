"""host_ms.ng_fisher: the median host milliseconds of the program's
`ng.fisher_update` span (training/train_step.py update_ng_states, on the
steps that fold NG's statistics in) over the window's steps
(harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "ng.fisher_update")
