"""The harness: one run of one cell.

`main` parses `--workload --seed --seconds --trace`, refuses to run without
the cards the cell asks for, loads the cell's workload file
(workloads/<cell>.json) and its configuration (configs/<config>.json),
hands both to the cell's driver (drivers/<driver>.py), reads the cell's
metrics from the driver's record with the readers in metrics/<metric>.py,
and prints the result line.  Everything a cell, a configuration or a
metric needs is found by its name, so adding one is adding files.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

from benchmark.harness.guard import blocked_modules

ROOT = Path(__file__).resolve().parents[2]


def process_start_time() -> float:
    """The wall-clock time this process started (Linux: from /proc), so
    that setup_s counts the interpreter's start and every import."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True, help="cell name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a driver or a metric reader from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell's entry in BENCHMARK.json, its workload file and its
    configuration file, merged: {"entry", "cell", "config", "metrics":
    {"end_to_end": [...], "per_layer": [...]}}."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(entries)}")
    entry = entries[name]
    cell = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    config = load_json(root / "benchmark" / "configs"
                       / f"{entry['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"root": root, "entry": entry, "cell": cell, "config": config,
            "metrics": {"end_to_end": e2e, "per_layer": per_layer},
            "run_seconds": bench["run_seconds"]}


def read_metrics(specs: list, rec: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read in the driver's record."""
    out = {}
    for m in specs:
        reader = load_module(root / "benchmark" / "metrics"
                             / f"{m['name']}.py", f"metric_{m['name']}")
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_entry(chips: int, rec: dict, device) -> dict:
    """The device keys of the result line.  A CPU device (the tests') says
    so: its numbers are never a card's."""
    import torch
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(rec["memory_peak_bytes"]),
           "power_limit": rec.get("power_limit")}
    if rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    return dev


def power_limit() -> Optional[str]:
    """nvidia-smi's "name, power limit" of the cards, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(spec: dict, args, device, t_start: float) -> dict:
    """Drive the cell and build its result line (a dict)."""
    cell = spec["cell"]
    driver = load_module(spec["root"] / "benchmark" / "drivers"
                         / f"{cell['driver']}.py", f"driver_{cell['driver']}")
    rec = driver.run(spec, args, device, t_start)
    metrics = read_metrics(spec["metrics"]["per_layer"] if args.trace
                           else spec["metrics"]["end_to_end"], rec,
                           spec["root"])
    result = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_entry(spec["entry"]["chips"], rec, device)}
    if args.trace and rec.get("trace"):
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in rec["checks"]}
    print("not compared: " + json.dumps(rec.get("check_info")),
          file=sys.stderr)
    print("host: " + json.dumps(rec.get("host")), file=sys.stderr)
    return result


def main(argv=None) -> int:
    t_start = process_start_time()
    args = parse_args(argv)
    spec = cell_spec(args.workload)
    chips = spec["entry"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args, torch.device("cuda", 0), t_start)
    found = blocked_modules()
    if found:
        print(f"error: the run loaded {sorted(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
