"""The TDNN-LSTM cell's driver, reference and counts at tiny sizes on the
CPU: with the program computing in float32 the reference follows it
through the three steps to float32 rounding; the faults the cell's
limits must catch move the reference's own readings; the counts add up
by hand; and the cell's files name what exists."""

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

import tiny
from benchmark.counts.lstmp import (
    recurrence_work, recurrences, step_flops,
)
from benchmark.harness import core
from benchmark.reference import tdnn_lstm as ref

BENCH = Path(__file__).resolve().parents[1]

XCONFIG = """\
input dim=10 name=ivector
input dim=8 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=16
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=16
fast-lstmp-layer name=lstm1 cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=-3 decay-time=20
relu-renorm-layer name=tdnn3 input=Append(-3,0,3) dim=16
fast-lstmp-layer name=lstm2 cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=-3 decay-time=20
output-layer name=output input=lstm2 output-delay=5 include-log-softmax=false dim=24 max-change=1.5
output-layer name=output-xent input=lstm2 output-delay=5 dim=24 learning-rate-factor=5.0 max-change=1.5
"""

CONFIG = dict(tiny.CONFIG, name="tiny_lstm", xconfig="tiny_lstm.xconfig",
              compute_dtype="float32")

# context 11 left, 1 right; 6 frames of extra left context
STEP = {
    "config": "tiny_lstm", "driver": "step_recurrent", "batch": 3,
    "frames_in": 36, "frames_out": 6, "left_context": 17,
    "deriv_truncate_margin": 2, "batches": 3, "learning_rate": 0.001,
    "momentum": 0.9, "max_param_change": 2.0, "l2_regularize": 0.0,
    "xent_regularize": 0.0, "leaky_hmm": 1e-05,
    "out_of_range_regularize": 0.01, "natural_gradient": False,
    "warmup_steps": 4, "trace_steps": 2, "probe_limit": 1e-4,
    "probe_limit_fp32": 1e-4,
    "limits": tiny.LIMITS,
}


def make_root(tmp: Path, cell: dict = STEP) -> Path:
    root = tiny.make_root(tmp, {"tiny_lstm.step": cell})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_lstm", "source": "tests",
                         "file": "benchmark/configs/tiny_lstm.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"][0]["config"] = "tiny_lstm"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "configs" / "tiny_lstm.xconfig").write_text(XCONFIG)
    (root / "benchmark" / "configs" / "tiny_lstm.json").write_text(
        json.dumps(CONFIG))
    return root


def run(root, seed=2**40 + 7):
    spec = core.cell_spec("tiny_lstm.step", root)
    args = argparse.Namespace(workload="tiny_lstm.step", seed=seed,
                              seconds=0.3, trace=0)
    return core.run_cell(spec, args, torch.device("cpu"), time.time())


def test_reference_follows_the_port(tmp_path, two_threads):
    res = run(make_root(tmp_path))
    gaps = {k: v["value"] for k, v in res["checks"].items()}
    assert max(gaps.values()) < 2e-5, gaps
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def _spec(tmp_path):
    return core.cell_spec("tiny_lstm.step", make_root(tmp_path))


@pytest.mark.parametrize("fault", ["bf16_c", "s1", "no_peephole",
                                   "no_delay"])
def test_faults_move_the_reference(tmp_path, two_threads, fault):
    """Each fault the cell's limits must catch changes the reference's
    outputs or its update far beyond float32 rounding."""
    from benchmark.drivers import step_recurrent as drv
    from benchmark.harness import training as tr
    spec = _spec(tmp_path)
    dev = torch.device("cpu")
    model = drv.ref_model(spec)
    weights = ref.make_weights(model, 5, dev)
    batches = drv.batches_of(spec, 3, dev, 2)
    sound = drv.reference_readings(spec, weights, batches, [1e-3] * 2, dev)
    bad = drv.reference_readings(spec, weights, batches, [1e-3] * 2, dev,
                                 faults=(fault,))
    values, _ = tr.gaps(bad, sound)
    assert max(values["out_gap"], values["grad_gap"]) > 1e-3, values


@pytest.mark.parametrize("bf16", [True, False])
def test_probe_is_the_steps_first_recurrence(tmp_path, two_threads, bf16):
    """The probe is the program's first recurrence of step 1, on the
    layer's grid (3 frames a step, delay one step); the program's plain
    loop equals the reference's cell on it in either mode, and a cell
    state held in bf16 moves the reference far past the cell's limit."""
    from benchmark.drivers import step_recurrent as drv
    spec = _spec(tmp_path)
    dev = torch.device("cpu")
    r = drv.Run(drv.prepare(spec, dev), spec, 2**40 + 7, dev)
    r.first_steps()
    probe = r.probe
    steps = probe["steps"]
    assert (steps.frame_step, steps.delay, steps.recurrence_frames) == \
        (3, 1, 3)
    assert probe["leaves"][0].shape[:2] == probe["g_r"].shape[:2]
    sound = drv.probe_reference(spec, probe, bf16=bf16)
    assert drv.probe_gap(drv.probe_program(probe, bf16), sound) < 1e-6
    bad = drv.probe_reference(spec, probe, ("bf16_c",), bf16=bf16)
    limit = json.loads((BENCH / "workloads" / "tdnn_lstm.step.json")
                       .read_text())["probe_limit"]
    assert drv.probe_gap(bad, sound) > 2 * limit


def test_counts_by_hand():
    w = recurrence_work(B=2, steps=3, C=4, R=2, op_bytes=2)
    f = w["forward"]
    assert f["flops"] == 3 * (2 * 2 * 2 * 16 + 2 * 2 * 4 * 2 + 20 * 2 * 4)
    assert f["bytes"] == 6 * (64 + 16 + 8 + 8) + 2 * (2 * 16 + 4 * 2)
    b = w["backward"]
    assert b["flops"] == 3 * (2 * 2 * 2 * 4 + 2 * 2 * 16 * 2 + 30 * 2 * 4)
    model = ref.parse(XCONFIG)
    work = recurrences(model, 3, 36, 3, 17)
    # the grid below the delayed outputs: frames 0, 3, .. 30 (17 % 3 - 5 =
    # -3 -> one frame of padding), lstm1 defined from frame 3 (step 1),
    # lstm2 from frame 6 (step 2)
    assert [n for _, n, _ in work] == [10, 9]
    assert step_flops(model, 3, 36, 3, 17) > 0


def test_reference_context_and_shapes():
    model = ref.load(str(BENCH / "configs" / "tdnn_lstm.xconfig"))
    assert model.context() == (21, 11)
    shapes = ref.param_shapes(model)
    total = sum(torch.Size(s).numel() for p in shapes.values()
                for s in p.values())
    cfg = json.loads((BENCH / "configs" / "tdnn_lstm.json").read_text())
    # the configuration's count is the trainable one: the LDA is fixed
    lda = sum(torch.Size(s).numel() for s in shapes["lda"].values())
    assert total - lda == cfg["parameters"]
    assert tuple(cfg["time_context"]) == model.context()


def test_cell_files_name_what_exists():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}["tdnn_lstm.step"]
    cell = json.loads((BENCH / "workloads" / "tdnn_lstm.step.json")
                      .read_text())
    assert cell["config"] == entry["config"] == "tdnn_lstm"
    assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
    cfg = json.loads((BENCH / "configs" / "tdnn_lstm.json").read_text())
    assert (BENCH / "configs" / cfg["xconfig"]).is_file()
    left, right = cfg["time_context"]
    recipe = cfg["recipe"]
    assert cell["left_context"] == recipe["chunk_left_context"] + left
    assert cell["frames_in"] == (recipe["chunk_width"] + recipe[
        "chunk_left_context"] + left + right)
    assert cell["frames_out"] * cfg["frame_subsampling_factor"] == \
        recipe["chunk_width"]
    for m in ("lstmp_roofline_pct", "host_ms.lstmp",
              "host_ms.lstmp_backward"):
        assert (BENCH / "metrics" / f"{m}.py").is_file()


def test_readers_find_nothing_without_the_kernel():
    from benchmark.harness.core import load_module
    rec = {"trace": {"kernels": {"fwd_init_kernel": {"seconds": 1.0,
                                                     "launches": 2}}},
           "lstmp_bound": {"bound_s_per_step": 1e-4, "launches_per_step": 6},
           "steps": 3}
    reader = load_module(BENCH / "metrics" / "lstmp_roofline_pct.py", "m")
    assert reader.read(rec) is None
    rec["trace"]["kernels"]["lstmp_fwd_kernel"] = {"seconds": 0.003,
                                                   "launches": 3}
    rec["trace"]["kernels"]["lstmp_bwd_kernel"] = {"seconds": 0.003,
                                                   "launches": 3}
    assert reader.read(rec) == pytest.approx(100 * 1e-4 / 0.006)
