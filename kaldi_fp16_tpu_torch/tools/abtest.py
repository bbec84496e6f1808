"""abtest: two identical synthetic trainings (same data, seeds and
schedule) that differ in one mode; their objf trajectories compared.

The twin of tools/abtest.py, driving `python -m
kaldi_fp16_tpu_torch.tools.train` on --device (default: the current CUDA
device).  Modes (--ab):

  grid        full-rate post-CNN stack ("exact" arm, --no-grid) vs
              frame-grid subsampling ("fast" arm): two legitimate
              semantics, vetted for convergence equivalence
  feats-bf16  fp32 vs bf16 host feature upload (the inputs are consumed
              in bf16 either way)
  den-mode, bn-lowp   revoked in the JAX package and not ported
              (ROADMAP.md queue 1 item 5): the tool exits 2

The default is grid (the JAX tool's default, den-mode, is revoked).

Usage:
  python -m kaldi_fp16_tpu_torch.tools.abtest [--ab grid|feats-bf16]
      [--workdir /tmp/abtest] [--epochs 6] [--batch 16] [--pdfs 96]
      [--files 4] [--per-file 32] [--den-states 96] [--frames-in 48]
      [--frames-out 15] [--lr 1e-3] [--xconfig F] [--seed 0]
      [--data-seed 0] [--device cpu]

Writes WORKDIR/ab_result.json and prints a markdown table and one JSON
line.  `main(argv)` returns the result dict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from kaldi_fp16_tpu_torch.tools._common import read_metrics, tool_device

ROOT = Path(__file__).resolve().parents[2]
REVOKED = ("den-mode", "bn-lowp")
ARMS = {
    "grid": (("exact", ["--no-grid"]), ("fast", [])),
    "feats-bf16": (("exact", []), ("fast", ["--feats-bf16"])),
}
METRIC = {"grid": "grid_subsample_ab", "feats-bf16": "feats_bf16_ab"}


def run(cmd, log_path):
    """Run cmd with its output in log_path; its wall seconds."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                           cwd=ROOT)
    if r.returncode != 0:
        with open(log_path) as f:
            tail = f.read().splitlines()[-15:]
        raise SystemExit(f"command failed: {' '.join(cmd)}\n"
                         + "\n".join(tail))
    return time.perf_counter() - t0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.abtest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--ab", default="grid",
                    choices=["den-mode", "bn-lowp", "grid", "feats-bf16"],
                    help="which mode to A/B (den-mode and bn-lowp are "
                         "revoked and not ported)")
    ap.add_argument("--workdir", default="/tmp/abtest")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pdfs", type=int, default=96)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--per-file", type=int, default=32)
    ap.add_argument("--den-states", type=int, default=96)
    ap.add_argument("--frames-in", type=int, default=48)
    ap.add_argument("--frames-out", type=int, default=15)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--xconfig", default=None,
                    help="default: a small tdnnf recipe written into "
                         "workdir")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init / shuffle) of both arms")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="synthetic-egs seed (a new workdir per data "
                         "seed, or the cached egs are reused)")
    ap.add_argument("--device", default=None,
                    help="passed to tools.train (default: the current "
                         "CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.ab in REVOKED:
        print(f"abtest: --ab {args.ab} is not ported: the mode was revoked "
              f"in the JAX package (ROADMAP.md queue 1 item 5)",
              file=sys.stderr)
        raise SystemExit(2)
    tool_device("abtest", args.device)   # no card and no --device: stop here

    os.makedirs(args.workdir, exist_ok=True)
    egs_dir = os.path.join(args.workdir, "egs")
    py = sys.executable
    if not os.path.exists(os.path.join(egs_dir, "cegs.1.ark")):
        run([py, "-m", "kaldi_fp16_tpu_torch.tools.make_synthetic_egs",
             egs_dir, "--files", str(args.files),
             "--per-file", str(args.per_file), "--pdfs", str(args.pdfs),
             "--den-states", str(args.den_states),
             "--frames-in", str(args.frames_in),
             "--frames-out", str(args.frames_out),
             "--seed", str(args.data_seed), "--den-topology", "phone-lm"],
            os.path.join(args.workdir, "egs.log"))

    xconfig = args.xconfig
    if xconfig is None:
        xconfig = os.path.join(args.workdir, "model.xconfig")
        with open(xconfig, "w") as f:
            f.write(f"""\
input name=input dim=40
linear-component name=linear1 dim=96
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=96 bottleneck-dim=32 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=96 bottleneck-dim=32 time-stride=1 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=48 big-dim=96
output-layer name=output dim={args.pdfs} include-log-softmax=false
""")

    result = {"config": vars(args), "runs": {}}
    for mode, extra in ARMS[args.ab]:
        metrics = os.path.join(args.workdir, f"metrics_{mode}.jsonl")
        if os.path.exists(metrics):
            os.unlink(metrics)
        wall = run(
            [py, "-m", "kaldi_fp16_tpu_torch.tools.train",
             "--egs", os.path.join(egs_dir, "cegs.*.ark"),
             "--den-fst", os.path.join(egs_dir, "den.fst"),
             "--xconfig", xconfig, "--pdfs", str(args.pdfs),
             "--epochs", str(args.epochs), "--batch", str(args.batch),
             "--lr", str(args.lr), "--momentum", "0.5",
             "--metrics", metrics, "--seed", str(args.seed)] + extra
            + (["--device", args.device] if args.device else []),
            os.path.join(args.workdir, f"train_{mode}.log"))
        rows = [r for r in read_metrics(metrics) if "objf_per_frame" in r]
        result["runs"][mode] = {
            "wall_s": round(wall, 1),
            "steps": len(rows),
            "objf_trajectory": [round(r["objf_per_frame"], 6)
                                for r in rows],
            "final_objf": rows[-1]["objf_per_frame"] if rows else None,
        }

    ex = result["runs"]["exact"]["objf_trajectory"]
    fa = result["runs"]["fast"]["objf_trajectory"]
    n = min(len(ex), len(fa))
    diffs = [abs(a - b) for a, b in zip(ex[:n], fa[:n])]
    result["max_abs_objf_diff"] = max(diffs) if diffs else None
    result["final_objf_diff"] = abs(ex[-1] - fa[-1]) if ex and fa else None

    with open(os.path.join(args.workdir, "ab_result.json"), "w") as f:
        json.dump(result, f, indent=1)

    print("| step | exact objf/frame | fast objf/frame | diff |")
    print("|---|---|---|---|")
    for i in sorted({0, n // 4, n // 2, 3 * n // 4, n - 1}):
        if 0 <= i < n:
            print(f"| {i + 1} | {ex[i]:.5f} | {fa[i]:.5f} | "
                  f"{abs(ex[i] - fa[i]):.2e} |")
    print(json.dumps({
        "metric": METRIC[args.ab],
        "final_objf_exact": ex[-1] if ex else None,
        "final_objf_fast": fa[-1] if fa else None,
        "final_objf_diff": result["final_objf_diff"],
        "max_abs_objf_diff": result["max_abs_objf_diff"],
        "wall_exact_s": result["runs"]["exact"]["wall_s"],
        "wall_fast_s": result["runs"]["fast"]["wall_s"],
    }))
    return result


if __name__ == "__main__":
    main()
