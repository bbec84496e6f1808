"""The port's host spans (kaldi_fp16_tpu_torch/utils/spans.py), on the CPU.

* Without a profiler a span records its duration, start and count, and
  opens no `record_function`; threads that record one name lose no
  occurrence.
* Under torch.profiler a span is a `user_annotation` of the Chrome
  trace, and the registry's start time is the event's `ts` plus the
  trace's `baseTimeNanoseconds` within 1 ms.
* The loader's span runs on a PrefetchLoader's thread, and
  `LoaderStats.read_seconds` is its time.
* One train step records each of its spans once, nested inside
  `train_step` in code order; a Trainer epoch with NG records
  `ng.fisher_update` on the steps that fold in statistics only.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.io import dataloader as pdl
from kaldi_fp16_tpu_torch.io.fst import read_fst_file
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import Network
from kaldi_fp16_tpu_torch.training import train_step as port_ts
from kaldi_fp16_tpu_torch.training.loss_scale import init_loss_scale
from kaldi_fp16_tpu_torch.training.optimizer import init_sgd_state
from kaldi_fp16_tpu_torch.training.trainer import Trainer
from kaldi_fp16_tpu_torch.utils import spans
from tests.test_chain_numerator import random_fst
from tests.test_torch_train_step import DEN_KW, LEFT, P, STRIDE, XCONFIG
from tests.test_torch_train_tool import EGS_XCONFIG
from tests.test_torch_trainer import NG_CFG

STEP_SPANS = ("train_step.forward", "chain.den", "chain.numerator",
              "train_step.backward", "train_step.read", "train_step.update")


@pytest.fixture(autouse=True)
def empty_registry():
    spans.reset()
    yield
    spans.reset()


def intervals(name):
    s = spans.snapshot()[name]
    return [(t, t + ms * 1e6) for t, ms in zip(s["start_ns"], s["ms"])]


def test_spans_record_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    before = time.time_ns()
    for _ in range(3):
        with spans.span("t.outer") as s:
            with spans.span("t.inner"):
                time.sleep(0.002)
    after = time.time_ns()
    snap = spans.snapshot()
    assert set(snap) == {"t.outer", "t.inner"}
    assert snap["t.outer"]["count"] == snap["t.inner"]["count"] == 3
    assert all(2.0 <= ms for ms in snap["t.inner"]["ms"])
    assert s.ns == pytest.approx(snap["t.outer"]["ms"][-1] * 1e6)
    for (o0, o1), (i0, i1) in zip(intervals("t.outer"),
                                  intervals("t.inner")):
        assert before - 1e6 <= o0 <= i0 <= i1 <= o1 <= after + 1e6


def test_the_ring_keeps_the_newest():
    for k in range(spans.RING + 5):
        with spans.span("t.ring"):
            pass
    snap = spans.snapshot()["t.ring"]
    assert snap["count"] == spans.RING + 5
    assert len(snap["ms"]) == len(snap["start_ns"]) == spans.RING
    assert snap["start_ns"] == sorted(snap["start_ns"])


def test_threads_recording_one_name_lose_no_occurrence():
    threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def record():
            for _ in range(each):
                with spans.span("t.shared"):
                    pass
        ts = [threading.Thread(target=record) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = spans.snapshot()["t.shared"]
    assert snap["count"] == threads * each
    assert all(ms >= 0 for ms in snap["ms"])


def test_spans_are_user_annotations_on_the_trace_clock(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.span("t.warm"):      # the first record_function sets up
            pass
        for _ in range(2):
            with spans.span("t.outer"):
                torch.ones(64).add_(1)
                with spans.span("t.inner"):
                    time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    for name in ("t.outer", "t.inner"):
        events = sorted((e for e in trace["traceEvents"]
                         if e.get("name") == name), key=lambda e: e["ts"])
        assert [e["cat"] for e in events] == ["user_annotation"] * 2
        starts = spans.snapshot()[name]["start_ns"]
        for e, start in zip(events, starts):
            assert abs(e["ts"] * 1e3 + base - start) < 1e6


def write_egs(tmp_path):
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
    make_synthetic_egs.main([str(tmp_path), "--files", "2", "--per-file",
                             "8", "--pdfs", "12", "--frames-in", "27",
                             "--frames-out", "8", "--den-states", "12",
                             "--den-topology", "phone-lm", "--seed", "1"])
    return str(tmp_path / "cegs.*.ark")


def loader(pattern, batch_size):
    return pdl.DataLoader(pattern, pdl.DataLoaderConfig(
        batch_size=batch_size, label_dim=12, shuffle_files=True,
        shuffle_buffer=6, seed=2, max_fst_states=16, max_fst_arcs=24))


def test_loader_spans_run_on_the_prefetch_thread(tmp_path):
    """One `loader.batch` a batch and one for the epoch's end, recorded
    on the producer's thread, and read_seconds is their time."""
    dl = loader(write_egs(tmp_path), 4)
    main = threading.get_ident()
    seen = []
    real = spans.span.__enter__

    def enter(self):
        seen.append(threading.get_ident())
        return real(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans.span, "__enter__", enter)
        batches = list(pdl.PrefetchLoader(dl, depth=2))
    snap = spans.snapshot()["loader.batch"]
    assert len(batches) == dl.stats.batches == 4
    assert snap["count"] == 5
    assert seen and main not in seen
    assert dl.stats.read_seconds == pytest.approx(sum(snap["ms"]) * 1e-3)


def test_one_train_step_records_each_span_once_inside_train_step():
    T_in, B = 18, 2
    T_out = (T_in - LEFT + STRIDE - 1) // STRIDE
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (T_out + 1),
                                  num_pdfs=P, T=T_out)) for _ in range(B)]
    batch = {"features": torch.randn(B, T_in, 8),
             "ivectors": torch.randn(B, 10),
             "weights": torch.ones(B)}
    model = build_model_from_string(XCONFIG)
    net = Network(model, torch.Generator().manual_seed(0), "cpu")
    den = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    config = port_ts.TrainConfig(
        learning_rate=0.01, momentum=0.9, frame_subsampling_factor=STRIDE,
        left_context=LEFT, compute_dtype="float32")
    step = port_ts.make_train_step(
        model, net, den, port_graph.build_numerator_batch(csrs),
        ChainTrainingOpts(), config, num_frames_out=T_out)
    spans.reset()
    step(init_sgd_state(net.params), init_loss_scale(1.0, device="cpu"),
         batch)
    snap = spans.snapshot()
    assert set(snap) == {"train_step", *STEP_SPANS}
    assert all(s["count"] == 1 for s in snap.values())
    (outer,) = intervals("train_step")
    inner = [intervals(name)[0] for name in STEP_SPANS]
    assert all(outer[0] <= a <= b <= outer[1] for a, b in inner)
    assert all(b <= c for (_, b), (c, _) in zip(inner, inner[1:]))


def test_trainer_epoch_folds_the_fisher_update_on_due_steps(tmp_path):
    pattern = write_egs(tmp_path)
    cfg = dict(NG_CFG, left_context=0, momentum=0.5, learning_rate=0.002)
    trainer = Trainer(
        build_model_from_string(EGS_XCONFIG), DenominatorComputation(
            port_graph.DenominatorGraph.from_fst(
                read_fst_file(str(tmp_path / "den.fst")), 12),
            leaky=1e-5, device="cpu"),
        port_ts.TrainConfig(**cfg), ChainTrainingOpts(xent_regularize=0.1),
        device="cpu")
    spans.reset()
    trainer.train_epoch(loader(pattern, 2))
    snap = spans.snapshot()
    steps = 8
    for name in ("train_step", "trainer.place_batch", "ng.precondition",
                 *STEP_SPANS):
        assert snap[name]["count"] == steps, name
    assert snap["loader.batch"]["count"] == steps + 1
    # counters 0 and 4 fold in (update_period 4): steps 1 and 5
    fisher = intervals("ng.fisher_update")
    step_iv = intervals("train_step")
    assert [k for k, (a, b) in enumerate(step_iv)
            if any(a <= f0 <= f1 <= b for f0, f1 in fisher)] == [0, 4]
    assert len(fisher) == 2
