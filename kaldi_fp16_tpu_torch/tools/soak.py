"""soak: flagship-recipe training killed mid-run with SIGKILL and resumed.

The twin of tools/soak.py.  It drives `python -m
kaldi_fp16_tpu_torch.tools.train` with the JAX tool's recipe flags (NG-SGD,
the orthonormal constraint, dynamic loss scaling, the exponential LR, the
xent head, JSONL metrics, checkpoints) on synthetic cegs, SIGKILLs it once
the metrics show --kill-after-steps steps, resumes it with --resume, and
checks:

  * the resumed run continues from a recent checkpoint (no restart),
  * the steps it re-trains between its checkpoint and the kill reproduce
    run 1's objf exactly (parameters, optimizer and loss-scale state, the
    SpecAugment generator and the data position all restored; the child
    trains inside tools.train's deterministic cuDNN scope),
  * the objf/frame stays in the trailing pre-kill band,
  * the LR schedule position is preserved,
  * no NaN / skipped-step cascade after the resume.

The checkpoint writer renames a complete file into place, so a kill
inside a save leaves the previous checkpoint the newest one; the no-restart
check allows a resume up to two checkpoint intervals before the kill.
The metrics file is polled every POLL_S seconds (the JAX tool: 5 s), so
the kill lands near its step on a fast card.

Writes WORKDIR/soak_result.json with the JAX tool's keys.  Usage:
  python -m kaldi_fp16_tpu_torch.tools.soak [--workdir /tmp/soak]
      [--epochs 4] [--batch 16] [--pdfs 3080] [--files 4] [--per-file 96]
      [--kill-after-steps 25] [--ckpt-every 10] [--xconfig F] [--device cpu]

`main(argv)` returns the result dict with "ok"; run as a program it exits
1 unless every check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from kaldi_fp16_tpu_torch.tools._common import read_metrics, tool_device

ROOT = Path(__file__).resolve().parents[2]
POLL_S = 0.05
RUN_LIMIT_S = 7200


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.soak",
        description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="/tmp/soak")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--per-file", type=int, default=96)
    ap.add_argument("--kill-after-steps", type=int, default=25,
                    help="SIGKILL the first run once metrics show this "
                         "many steps (mid-epoch)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--xconfig",
                    default=str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    ap.add_argument("--device", default=None,
                    help="passed to tools.train (default: the current "
                         "CUDA device)")
    return ap.parse_args(argv)


def train_command(args, egs_dir, metrics, ckpt):
    return [
        sys.executable, "-m", "kaldi_fp16_tpu_torch.tools.train",
        "--egs", os.path.join(egs_dir, "cegs.*.ark"),
        "--den-fst", os.path.join(egs_dir, "den.fst"),
        "--xconfig", args.xconfig,
        "--pdfs", str(args.pdfs), "--epochs", str(args.epochs),
        "--batch", str(args.batch), "--lr", "1e-3", "--lr-final", "1e-4",
        "--momentum", "0.5", "--natural-gradient", "--loss-scaling",
        "--orthonormal-interval", "4", "--xent-regularize", "0.1",
        "--metrics", metrics, "--ckpt-dir", ckpt,
        "--ckpt-every", str(args.ckpt_every), "--log-every", "5",
        "--seed", "0",
    ] + (["--device", args.device] if args.device else [])


def log_tail(path, n):
    with open(path) as f:
        return "\n".join(f.read().splitlines()[-n:])


def kill_run(cmd, log_path, metrics, kill_after):
    """Run 1: train until the metrics show `kill_after` steps, then
    SIGKILL.  Returns the steps seen at the kill."""
    with open(log_path, "w") as log:
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                             cwd=ROOT)
        t0 = time.time()
        try:
            while p.poll() is None:
                time.sleep(POLL_S)
                steps = len(read_metrics(metrics))
                if steps >= kill_after:
                    p.send_signal(signal.SIGKILL)
                    p.wait()
                    return steps
                if time.time() - t0 > RUN_LIMIT_S:
                    raise SystemExit(f"run 1 exceeded {RUN_LIMIT_S} s before "
                                     f"reaching {kill_after} steps")
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    if p.returncode != 0:
        raise SystemExit(f"run 1 CRASHED (rc={p.returncode}) before the "
                         f"kill point:\n{log_tail(log_path, 12)}")
    raise SystemExit("run 1 finished before the kill point: raise --epochs "
                     "or lower --kill-after-steps")


def resume_run(cmd, log_path):
    """Run 2: the same command with --resume, to its end."""
    with open(log_path, "w") as log:
        r = subprocess.run(cmd + ["--resume"], stdout=log,
                           stderr=subprocess.STDOUT, timeout=RUN_LIMIT_S,
                           cwd=ROOT)
    if r.returncode != 0:
        raise SystemExit("resume run failed:\n" + log_tail(log_path, 15))


def main(argv=None) -> dict:
    args = parse_args(argv)
    tool_device("soak", args.device)   # no card and no --device: stop here
    os.makedirs(args.workdir, exist_ok=True)
    egs_dir = os.path.join(args.workdir, "egs")
    metrics = os.path.join(args.workdir, "metrics.jsonl")
    ckpt = os.path.join(args.workdir, "ckpt")

    if not os.path.exists(os.path.join(egs_dir, "cegs.1.ark")):
        from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
        make_synthetic_egs.main([
            egs_dir, "--files", str(args.files), "--per-file",
            str(args.per_file), "--pdfs", str(args.pdfs),
            "--frames-in", "48", "--frames-out", "15",
            "--den-states", "256", "--den-topology", "phone-lm"])

    cmd = train_command(args, egs_dir, metrics, ckpt)
    if os.path.exists(metrics):
        os.unlink(metrics)
    # a previous soak's checkpoints would collide with run 1's and give
    # run 2 that run's final checkpoint
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    kill_run(cmd, os.path.join(args.workdir, "run1.log"), metrics,
             args.kill_after_steps)
    rows1 = read_metrics(metrics)
    resume_run(cmd, os.path.join(args.workdir, "run2.log"))
    rows2 = read_metrics(metrics)
    result = check(rows1, rows2, args.ckpt_every)
    with open(os.path.join(args.workdir, "soak_result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    ok = (result["resume_ok"] and result["continuity_ok"]
          and result["lr_schedule_preserved"] and result["no_restart"]
          and result["replay_exact"])
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return {**result, "ok": bool(ok)}


def check(rows1, rows2, ckpt_every) -> dict:
    """tools/soak.py's checks on run 1's metrics rows and both runs'."""
    pre_tail = [r["objf_per_frame"] for r in rows1[-8:]]
    pre_steps = [r["step"] for r in rows1]
    new = [r for r in rows2 if r["step"] > max(pre_steps)]
    # the metrics file is appended: rows2 = run 1's rows + run 2's
    run2_rows = rows2[len(rows1):]
    first_run2_step = run2_rows[0]["step"] if run2_rows else 0
    last_ckpt_step = (max(pre_steps) // ckpt_every) * ckpt_every
    post_head = [r["objf_per_frame"] for r in new[:8]]
    lr_pre = {r["step"]: r["lr"] for r in rows1}
    lr_ok = all(abs(r["lr"] - lr_pre.get(r["step"], r["lr"])) < 1e-9
                for r in rows2 if r["step"] in lr_pre)
    # resumed one past a checkpoint boundary within two intervals of the
    # kill: the kill can land inside the save at the kill step itself
    no_restart = (first_run2_step > 0
                  and (first_run2_step - 1) % ckpt_every == 0
                  and first_run2_step > max(0, last_ckpt_step
                                            - 2 * ckpt_every))
    # the re-trained steps must reproduce run 1's objf exactly
    objf1 = {r["step"]: r["objf_per_frame"] for r in rows1}
    replayed = [r for r in run2_rows if r["step"] in objf1]
    replay_diffs = [abs(r["objf_per_frame"] - objf1[r["step"]])
                    for r in replayed]
    replay_exact = all(d == 0.0 for d in replay_diffs)
    spread = max(pre_tail) - min(pre_tail) + 0.02
    lo, hi = min(pre_tail) - 3.0 * spread, max(pre_tail) + 3.0 * spread
    continuity = (all(lo <= v <= hi for v in post_head)
                  and all(np.isfinite(v) for v in post_head)
                  and bool(post_head))
    return {
        "killed_at_step": len(rows1),
        "last_ckpt_step": last_ckpt_step,
        "resumed_at_step": first_run2_step,
        "resume_ok": 0 < first_run2_step <= len(rows1) + 1,
        "no_restart": bool(no_restart),
        "replayed_steps": len(replayed),
        "replay_max_objf_diff": max(replay_diffs) if replay_diffs else 0.0,
        "replay_exact": bool(replay_exact),
        "pre_kill_tail_objf": pre_tail,
        "post_resume_head_objf": post_head,
        "continuity_band": [lo, hi],
        "continuity_ok": bool(continuity),
        "lr_schedule_preserved": bool(lr_ok),
        "final_objf": rows2[-1]["objf_per_frame"] if rows2 else None,
        "total_steps": len(rows2),
    }


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
