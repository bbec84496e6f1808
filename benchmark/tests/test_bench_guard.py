"""The harness imports neither JAX nor the JAX package, compared by whole
top-level names, and a run without a card exits non-zero with no result."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness.guard import blocked_modules

ROOT = Path(__file__).resolve().parents[2]

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "kaldi_fp16_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def test_top_level_names_compared_whole():
    assert blocked_modules({"kaldi_fp16_tpu_torch", "kaldi_fp16_tpu_torch.io",
                            "jaxtyping", "numpy"}) == set()
    assert blocked_modules({"kaldi_fp16_tpu.chain", "jax.numpy"}) == {
        "kaldi_fp16_tpu", "jax"}


def test_harness_imports_with_jax_blocked():
    code = BLOCKER.format(root=str(ROOT)) + """
from pathlib import Path
from benchmark.harness import core, training, trace
from benchmark import calibrate
for d in ("recipe", "step"):
    core.load_module(Path({root!r}) / "benchmark" / "drivers" / (d + ".py"), d)
for m in (Path({root!r}) / "benchmark" / "metrics").glob("*.py"):
    core.load_module(m, "metric_" + m.stem)
import kaldi_fp16_tpu_torch.training.trainer, kaldi_fp16_tpu_torch.io.dataloader
from benchmark.harness.guard import blocked_modules
assert not blocked_modules(), blocked_modules()
print("ok")
""".replace("{root!r}", repr(str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cnn_tdnn_f.step",
         "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_exits_nonzero():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
