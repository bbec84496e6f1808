"""A cell, a configuration's cell or a per-layer metric added as files of
its own (and an entry in BENCHMARK.json) is found and run, with no file of
the harness edited."""

import json

import tiny
from test_bench_reference import run
from benchmark.harness import core


def test_new_workload_and_metric_are_found(tmp_path, two_threads):
    extra = dict(tiny.STEP, batches=2, frames_in=33, frames_out=10)
    root = tiny.make_root(tmp_path, {"tiny.step": tiny.STEP,
                                     "tiny.extra": extra})
    (root / "benchmark" / "metrics" / "steps_in_window.py").write_text(
        "def read(rec):\n    return rec.get('steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step (training.train_step)",
        "moves": "train_audio_s_per_s", "workloads": ["tiny.extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = core.cell_spec("tiny.extra", root)
    assert spec["cell"]["frames_in"] == 33
    assert "steps_in_window" in {m["name"] for m in
                                 spec["metrics"]["per_layer"]}
    assert "steps_in_window" not in {
        m["name"] for m in core.cell_spec("tiny.step",
                                          root)["metrics"]["per_layer"]}
    res = run(root, "tiny.extra", trace=1)
    assert res["metrics"]["steps_in_window"]["value"] >= 1
    assert "breakdown" in res and list(res)[-1] == "checks"
