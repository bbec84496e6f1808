"""A tiny copy of the benchmark for CPU tests: the flagship's layer types
(SpecAugment, CNN, TDNN-F, attention, prefinal, both heads) at narrow
widths, a 24-pdf phone-LM den, and one cell of each driver, written into a
temporary root beside the real harness's code."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

XCONFIG = """\
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
spec-augment-layer name=idct-spec-augment input=idct-batchnorm freq-max-proportion=0.5 time-zeroed-proportion=0.2 time-mask-max-frames=4
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-spec-augment, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4 learning-rate-factor=0.333 max-change=0.25
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
attention-relu-batchnorm-layer name=attention1 num-heads=3 value-dim=6 key-dim=4 num-left-inputs=5 num-right-inputs=2 time-stride=3
prefinal-layer name=prefinal-l input=attention1 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim=24
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim=24 learning-rate-factor=5.0
"""

CONFIG = {
    "name": "tiny", "xconfig": "tiny.xconfig", "pdfs": 24, "feat_dim": 8,
    "ivector_dim": 10, "frame_subsampling_factor": 3,
    "compute_dtype": "bfloat16",
    "den": {"generator": "phone_lm", "num_pdfs": 24, "num_phones": 12,
            "states_per_phone": 2, "branching": 4, "seed": 0, "states": 24,
            "chains": 12},
    "reduced": [],
}

LIMITS = {"out_gap": 0.1, "grad_gap": 0.1, "change_gap": 0.1,
          "chain_den_gap": 0.1, "chain_num_gap": 0.1, "chain_deriv_gap": 0.1}

RECIPE = {
    "config": "tiny", "driver": "recipe", "batch": 4, "frames_in": 30,
    "frames_out": 9, "left_context": 3, "egs": 16, "egs_repeats": 2,
    "egs_per_file": 8, "shuffle_buffer": 16, "prefetch": 2,
    "fst_pad_states": 16, "fst_pad_arcs": 32, "epochs": 15,
    "schedule_egs_per_epoch": 4096, "learning_rate": 0.001,
    "lr_final": 0.0001, "lr_warmup_steps": 0, "momentum": 0.0,
    "max_param_change": 2.0, "l2_regularize": 5e-05, "xent_regularize": 0.1,
    "leaky_hmm": 1e-05, "out_of_range_regularize": 0.01,
    "loss_scaling": True, "natural_gradient": True, "ng_rank_in": 4,
    "ng_rank_out": 4, "ng_update_period": 4, "orthonormal_interval": 4,
    "warmup_steps": 5, "trace_steps": 2, "limits": LIMITS,
}

STEP = {
    "config": "tiny", "driver": "step", "batch": 4, "frames_in": 30,
    "frames_out": 9, "left_context": 3, "batches": 4, "learning_rate": 0.001,
    "momentum": 0.9, "max_param_change": 2.0, "l2_regularize": 0.0,
    "xent_regularize": 0.0, "leaky_hmm": 1e-05,
    "out_of_range_regularize": 0.01, "natural_gradient": False,
    "ng_rank_in": 4, "ng_rank_out": 4, "warmup_steps": 5, "trace_steps": 2,
    "limits": LIMITS,
}


def make_root(tmp: Path, cells=None) -> Path:
    """A root holding BENCHMARK.json (the real one's metrics, the tiny
    cells), benchmark/metrics and drivers (the real ones), and the tiny
    configuration and workload files."""
    cells = cells or {"tiny.recipe": RECIPE, "tiny.step": STEP}
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    names = sorted(cells)
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names
    real["configs"] = [{"name": "tiny", "source": "tests",
                        "file": "benchmark/configs/tiny.json", "reduced": [],
                        "why": "CPU tests"}]
    real["workloads"] = [{"name": n, "config": "tiny", "traffic": n,
                          "chips": 1, "why": "CPU tests"} for n in names]
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    (tmp / "benchmark" / "workloads").mkdir()
    for d in ("metrics", "drivers"):
        shutil.copytree(BENCH / d, tmp / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(real))
    (tmp / "benchmark" / "configs" / "tiny.xconfig").write_text(XCONFIG)
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(CONFIG))
    for n, c in cells.items():
        (tmp / "benchmark" / "workloads" / f"{n}.json").write_text(
            json.dumps(c))
    return tmp
