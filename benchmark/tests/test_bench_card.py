"""On a card: one short run of a cell, the whole command, result line and
all.  Skips where there is no CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_step_cell_runs_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cnn_tdnn_f.step",
         "--seed", str(2**35 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
