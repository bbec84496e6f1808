"""The readers of the program's spans (harness/spans.py, metrics/host_ms.*
and loader_batch_ms): the median over the window's occurrences of a
planted registry, None without a registry or a span, and every reader on
the line of a tiny traced run."""

import sys

import pytest

import tiny
from test_bench_reference import run
from benchmark.harness import core
from benchmark.harness import spans as hs

READERS = {
    "host_ms.step": "train_step",
    "host_ms.forward": "train_step.forward",
    "host_ms.den": "chain.den",
    "host_ms.numerator": "chain.numerator",
    "host_ms.backward": "train_step.backward",
    "host_ms.read": "train_step.read",
    "host_ms.update": "train_step.update",
    "host_ms.ng_fisher": "ng.fisher_update",
    "host_ms.ng_precondition": "ng.precondition",
    "host_ms.place_batch": "trainer.place_batch",
    "loader_batch_ms": "loader.batch",
}
RECIPE_ONLY = {"host_ms.ng_fisher", "host_ms.ng_precondition",
               "host_ms.place_batch", "loader_batch_ms"}


def reader(metric):
    return core.load_module(core.ROOT / "benchmark" / "metrics"
                            / f"{metric}.py", f"metric_{metric}")


def planted(span):
    """4 set-up steps, 5 window steps, 2 traced steps, 1 s apart, and
    `span` (inside each step where it is not the step's own): 1 ms in
    set-up, 10-50 ms in the window, 90 ms in the traced steps."""
    starts = [k * 10**9 for k in range(11)]
    ms = [1.0, 1.0, 1.0, 1.0, 10.0, 20.0, 30.0, 40.0, 50.0, 90.0, 90.0]
    return {"train_step": {"count": 11, "ms": [m + 2 for m in ms],
                           "start_ns": starts},
            span: {"count": 11, "ms": ms,
                   "start_ns": [t + 10**6 for t in starts]}}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_the_windows_median(metric, monkeypatch):
    from kaldi_fp16_tpu_torch.utils import spans
    span = READERS[metric]
    snap = planted(span)
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    rec = {"steps": 5, "traced_steps": 2}
    assert reader(metric).read(rec) == 30.0
    # a record that does not place the window: every occurrence
    assert reader(metric).read({}) == 20.0
    monkeypatch.setattr(spans, "snapshot", lambda: {})
    assert reader(metric).read(rec) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_none_without_a_registry(metric, monkeypatch):
    """As on a program that predates the registry: its import fails."""
    import kaldi_fp16_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "kaldi_fp16_tpu_torch.utils.spans",
                        None)
    assert hs.registry() is None
    assert reader(metric).read({"steps": 5, "traced_steps": 2}) is None


@pytest.mark.parametrize("cell", ["tiny.recipe", "tiny.step"])
def test_traced_run_carries_the_span_readings(tmp_path, two_threads, cell):
    from kaldi_fp16_tpu_torch.utils import spans
    spans.reset()
    res = run(tiny.make_root(tmp_path), cell, trace=1)
    got = {m for m in res["metrics"] if m in READERS}
    want = set(READERS) - (set() if cell == "tiny.recipe" else RECIPE_ONLY)
    assert got == want
    vals = {m: res["metrics"][m]["value"] for m in got}
    assert all(v > 0 for v in vals.values())
    parts = sum(vals[m] for m in ("host_ms.forward", "host_ms.den",
                                  "host_ms.numerator", "host_ms.backward",
                                  "host_ms.read", "host_ms.update"))
    assert parts < vals["host_ms.step"] * 1.1
