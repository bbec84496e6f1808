"""The TDNN-BLSTM cell's driver, reference and counts at tiny sizes on the
CPU: with the program computing in float32 the reference follows it
through the three steps to float32 rounding; the faults the cell's
limits must catch move the reference's own readings; the counts add up
by hand; the two new readers read what they should; and the cell's files
name what exists."""

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

import tiny
from benchmark.counts.blstm import bound, recurrences, step_flops
from benchmark.counts.lstmp import recurrence_work
from benchmark.harness import core
from benchmark.reference import tdnn_blstm as ref

BENCH = Path(__file__).resolve().parents[1]

XCONFIG = """\
input dim=10 name=ivector
input dim=8 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=16
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=16
fast-lstmp-layer name=blstm1-forward input=tdnn2 cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=-3 decay-time=20
fast-lstmp-layer name=blstm1-backward input=tdnn2 cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=3 decay-time=20
fast-lstmp-layer name=blstm2-forward input=Append(blstm1-forward, blstm1-backward) cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=-3 decay-time=20
fast-lstmp-layer name=blstm2-backward input=Append(blstm1-forward, blstm1-backward) cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=4 delay=3 decay-time=20
output-layer name=output input=Append(blstm2-forward, blstm2-backward) output-delay=0 include-log-softmax=false dim=24 max-change=1.5
output-layer name=output-xent input=Append(blstm2-forward, blstm2-backward) output-delay=0 dim=24 learning-rate-factor=5.0 max-change=1.5
"""

CONFIG = dict(tiny.CONFIG, name="tiny_blstm", xconfig="tiny_blstm.xconfig",
              compute_dtype="float32")

# context 3 / 3; 9 frames of extra context a side: T_in = 9 + 3 + 16 + 3 + 9
STEP = {
    "config": "tiny_blstm", "driver": "step_bidirectional", "batch": 3,
    "frames_in": 40, "frames_out": 6, "left_context": 12,
    "deriv_truncate_margin": 2, "batches": 3, "learning_rate": 0.001,
    "momentum": 0.9, "max_param_change": 2.0, "l2_regularize": 0.0,
    "xent_regularize": 0.0, "leaky_hmm": 1e-05,
    "out_of_range_regularize": 0.01, "natural_gradient": False,
    "warmup_steps": 4, "trace_steps": 2, "probe_limit": 1e-4,
    "probe_limit_fp32": 1e-4,
    "limits": tiny.LIMITS,
}


def make_root(tmp: Path, cell: dict = STEP) -> Path:
    root = tiny.make_root(tmp, {"tiny_blstm.step": cell})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_blstm", "source": "tests",
                         "file": "benchmark/configs/tiny_blstm.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"][0]["config"] = "tiny_blstm"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "configs" / "tiny_blstm.xconfig").write_text(
        XCONFIG)
    (root / "benchmark" / "configs" / "tiny_blstm.json").write_text(
        json.dumps(CONFIG))
    return root


def run(root, seed=2**40 + 7):
    spec = core.cell_spec("tiny_blstm.step", root)
    args = argparse.Namespace(workload="tiny_blstm.step", seed=seed,
                              seconds=0.3, trace=0)
    return core.run_cell(spec, args, torch.device("cpu"), time.time())


def test_reference_follows_the_port(tmp_path, two_threads):
    res = run(make_root(tmp_path))
    gaps = {k: v["value"] for k, v in res["checks"].items()}
    assert max(gaps.values()) < 2e-5, gaps
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def _spec(tmp_path):
    return core.cell_spec("tiny_blstm.step", make_root(tmp_path))


@pytest.mark.parametrize("fault", ["no_reverse", "right_edge", "bf16_c",
                                   "s1"])
def test_faults_move_the_reference(tmp_path, two_threads, fault):
    """Each fault the cell's limits must catch changes the reference's
    outputs or its update far beyond float32 rounding."""
    from benchmark.drivers import step_bidirectional as drv
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
def test_probe_is_the_steps_first_reverse_recurrence(tmp_path, two_threads,
                                                     bf16):
    """The probe is the program's first reverse recurrence of step 1
    (blstm1-backward), on the layer's grid (3 frames a step, delay one
    step, the walk from the last step its input is defined at); the
    program's plain loop equals the reference's reverse cell on it in
    either mode, and each probe fault moves the reference past the cell's
    limit."""
    from benchmark.drivers import step_bidirectional as drv
    spec = _spec(tmp_path)
    dev = torch.device("cpu")
    r = drv.Run(drv.prepare(spec, dev), spec, 2**40 + 7, dev)
    r.first_steps()
    probe = r.probe
    steps = probe["steps"]
    assert steps.reverse
    assert (steps.frame_step, steps.delay, steps.recurrence_frames) == \
        (3, 1, 3)
    # grid frames 0, 3, .. 36; blstm1's input defined on frames 3 .. 36:
    # the walk from step 12 (frame 36)
    assert steps.start == 12
    sound = drv.probe_reference(spec, probe, bf16=bf16)
    assert drv.probe_gap(drv.probe_program(probe, bf16), sound) < 1e-6
    limit = json.loads((BENCH / "workloads" / "tdnn_blstm.step.json")
                       .read_text())["probe_limit"]
    for fault in ("no_reverse", "right_edge", "bf16_c", "s1"):
        bad = drv.probe_reference(spec, probe, (fault,), bf16=bf16)
        assert drv.probe_gap(bad, sound) > limit, fault


def test_counts_by_hand():
    model = ref.parse(XCONFIG)
    work = recurrences(model, 3, 40, 3, 12)
    # grid frames 0, 3, .. 36 (13 steps); blstm1's input defined on frames
    # 3 .. 36 (forward from step 1, reverse from step 12), blstm2's too
    assert [(n, s, rev) for n, s, rev, _ in work] == [
        ("blstm1-forward", 12, False), ("blstm1-backward", 13, True),
        ("blstm2-forward", 12, False), ("blstm2-backward", 13, True)]
    w = work[1][3]
    assert w == recurrence_work(3, 13, 16, 6)
    f = w["forward"]
    assert f["flops"] == 13 * (2 * 3 * 6 * 64 + 2 * 3 * 16 * 6 + 20 * 3 * 16)
    rev = bound(model, 3, 40, 3, 12, reverse=True)
    fwd = bound(model, 3, 40, 3, 12, reverse=False)
    assert rev["launches_per_step"] == fwd["launches_per_step"] == 4
    assert rev["bound_s_per_step"] == pytest.approx(
        2 * (w["forward"]["bound_s"] + w["backward"]["bound_s"]))
    # the step: every matmul 2 x its forward (weights' gradient and the
    # forward) plus the input gradient where it carries one; tdnn1 and the
    # LDA at the full rate, the rest on the 13 grid frames
    B, T, n = 3, 40, 13
    total = 2.0 * B * T * 50 * 50                       # the LDA
    total += 2.0 * 2 * B * T * 50 * 16                  # tdnn1: no input
    total += 3.0 * 2 * B * T * 48 * 16                  # tdnn2
    for name, steps_, _, _ in work:
        din = 16 if name.startswith("blstm1") else 20
        total += 3.0 * 2 * B * n * din * 64             # W_all's input rows
        total += 3.0 * 2 * B * n * 16 * 4               # W_rp's p columns
        total += 3.0 * 2 * B * steps_ * 6 * 64          # W_all's r rows
        total += 3.0 * 2 * B * steps_ * 16 * 6          # W_rp's r columns
    total += 2 * 3.0 * 2 * B * n * 20 * 24              # the two heads
    assert step_flops(model, B, T, 3, 12) == pytest.approx(total)


def test_reference_context_and_shapes():
    model = ref.load(str(BENCH / "configs" / "tdnn_blstm.xconfig"))
    assert model.context() == (4, 4)
    shapes = ref.param_shapes(model)
    total = sum(torch.Size(s).numel() for p in shapes.values()
                for s in p.values())
    cfg = json.loads((BENCH / "configs" / "tdnn_blstm.json").read_text())
    lda = sum(torch.Size(s).numel() for s in shapes["lda"].values())
    assert total - lda == cfg["parameters"]
    assert tuple(cfg["time_context"]) == model.context()


def test_cell_files_name_what_exists():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}["tdnn_blstm.step"]
    cell = json.loads((BENCH / "workloads" / "tdnn_blstm.step.json")
                      .read_text())
    assert cell["config"] == entry["config"] == "tdnn_blstm"
    assert entry["chips"] == 1
    assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
    cfg = json.loads((BENCH / "configs" / "tdnn_blstm.json").read_text())
    assert (BENCH / "configs" / cfg["xconfig"]).is_file()
    left, right = cfg["time_context"]
    recipe = cfg["recipe"]
    assert cell["left_context"] == recipe["chunk_left_context"] + left
    assert cell["frames_in"] == (
        recipe["chunk_width"] + recipe["chunk_left_context"] + left
        + recipe["chunk_right_context"] + right)
    assert cell["frames_out"] * cfg["frame_subsampling_factor"] == \
        recipe["chunk_width"]
    listed = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]
              if "tdnn_blstm.step" in m.get("workloads", [])}
    assert listed == {"train_audio_s_per_s", "train_step_mfu",
                      "den_scan_roofline_pct", "device_idle_share.train",
                      "host_ms.step", "host_ms.read",
                      "graph_replay_share.train", "lstmp_roofline_pct",
                      "lstmp_reverse_roofline_pct", "recurrence_device_ms"}
    for m in listed:
        assert (BENCH / "metrics" / f"{m}.py").is_file()


def _reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", f"m_{name}")


def test_new_readers():
    """lstmp_reverse_roofline_pct reads the reverse-walk kernels against
    the reverse bound, recurrence_device_ms every recurrence kernel a
    traced step; neither finds anything in a trace without them (the
    parent's program)."""
    rec = {"trace": {"kernels": {"fwd_init_kernel": {"seconds": 1.0,
                                                     "launches": 2}}},
           "lstmp_reverse_bound": {"bound_s_per_step": 1e-4,
                                   "launches_per_step": 6},
           "traced_steps": 2}
    pct, ms = _reader("lstmp_reverse_roofline_pct"), \
        _reader("recurrence_device_ms")
    assert pct.read(rec) is None and ms.read(rec) is None
    k = rec["trace"]["kernels"]
    k["lstmp_fwd_kernel"] = {"seconds": 0.004, "launches": 6}
    k["lstmp_bwd_kernel"] = {"seconds": 0.006, "launches": 6}
    assert pct.read(rec) is None
    assert ms.read(rec) == pytest.approx(1000 * 0.010 / 2)
    k["lstmp_rev_fwd_kernel"] = {"seconds": 0.004, "launches": 6}
    k["lstmp_rev_bwd_kernel"] = {"seconds": 0.002, "launches": 6}
    assert pct.read(rec) == pytest.approx(100 * 2 * 1e-4 / 0.006)
    assert ms.read(rec) == pytest.approx(1000 * 0.016 / 2)
    # the forward walks' share reads its own kernels only
    rec["lstmp_bound"] = {"bound_s_per_step": 1e-4, "launches_per_step": 6}
    assert _reader("lstmp_roofline_pct").read(rec) == pytest.approx(
        100 * 2 * 1e-4 / 0.010)
