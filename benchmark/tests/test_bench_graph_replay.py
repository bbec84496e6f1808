"""metrics/graph_replay_share.train: the window's `train_step.replay`
spans over its `train_step` spans, None where the program has no replay
span or no registry."""

import sys

from benchmark.harness import core

METRIC = "graph_replay_share.train"


def reader():
    return core.load_module(core.ROOT / "benchmark" / "metrics"
                            / f"{METRIC}.py", "metric_graph_replay_share")


def planted(replayed):
    """4 set-up steps, 5 window steps, 2 traced steps, 1 s apart; a
    replay span inside each step of `replayed` (0-based)."""
    starts = [k * 10**9 for k in range(11)]
    return {"train_step": {"count": 11, "ms": [5.0] * 11,
                           "start_ns": starts},
            "train_step.replay": {
                "count": len(replayed), "ms": [1.0] * len(replayed),
                "start_ns": [starts[k] + 10**6 for k in replayed]}}


def test_share_counts_the_windows_replays(monkeypatch):
    from kaldi_fp16_tpu_torch.utils import spans
    rec = {"steps": 5, "traced_steps": 2}
    # set-up replays (steps 1-3) and traced ones (9, 10) do not count
    for replayed, want in ((range(1, 11), 100.0), ([1, 2, 4, 5, 7, 9], 60.0),
                           ([1, 9, 10], 0.0)):
        monkeypatch.setattr(spans, "snapshot",
                            lambda r=replayed: planted(list(r)))
        assert reader().read(rec) == want
    # a record that does not place the window
    assert reader().read({}) is None


def test_share_is_none_without_the_span_or_the_registry(monkeypatch):
    from kaldi_fp16_tpu_torch.utils import spans
    import kaldi_fp16_tpu_torch.utils as utils
    snap = planted([])
    del snap["train_step.replay"]
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    assert reader().read({"steps": 5, "traced_steps": 2}) is None
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "kaldi_fp16_tpu_torch.utils.spans",
                        None)
    assert reader().read({"steps": 5, "traced_steps": 2}) is None
