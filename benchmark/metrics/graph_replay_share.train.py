"""graph_replay_share.train: the share of the window's train steps that
replayed a captured CUDA graph: the program's `train_step.replay` spans
(training/train_step.py) over its `train_step` spans, both counted where
they started inside the window (harness/spans.py), in %.

None where the program has no `train_step.replay` span (a step without
graphs), or where the record does not place the window."""

from benchmark.harness.spans import registry, window_ns


def read(rec):
    snap = registry()
    if not snap or "train_step.replay" not in snap:
        return None
    win = window_ns(snap, rec)
    if win is None:
        return None

    def inside(name):
        return sum(1 for t in snap[name]["start_ns"]
                   if win[0] <= t <= win[1])
    steps = inside("train_step")
    return 100.0 * inside("train_step.replay") / steps if steps else None
