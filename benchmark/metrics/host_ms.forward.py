"""host_ms.forward: the median host milliseconds of the program's
`train_step.forward` span (training/train_step.py, from the step's entry
through the chain head's frames: batch inputs, frame geometry, the network
forward) over the window's steps (harness/spans.py)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms(rec, "train_step.forward")
