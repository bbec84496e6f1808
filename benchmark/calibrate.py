"""Readings from which a cell's correctness limits are set.

  python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
      [--control-seeds 1,2,3]

In one process (the den and the model are built once), for each seed:
the program's first steps against the reference's (the sound reading),
and for each control seed, against the reference:

- control: the reference with the network's operands in float8, put in
  the program's place (the network's numbers);
- chain_control: the program's bf16 den (mode "fast") in the exact den's
  place and the reference numerator computed in bf16, on the program's own
  step-1 output (the chain's numbers);
- half_batch: the fault "half of the batch left out, the mean taken over
  the rest" (the reference on the first half of each batch, its
  sequences weighted twice);
- lr_doubled, momentum_ignored: the reference with its learning rates
  doubled, or its momentum 0 (faults of the update that max-change's cap
  can hide from the change's norm);
- bf16_reference: a witness, the reference with its operands in bf16,
  the program's precision.

A state left unchanged reads 1 in grad_gap, change_gap and change_vec_gap
by their definition.  One JSON line per seed; no timing.  Needs the cell's
card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import training as tr  # noqa: E402
from benchmark.harness.core import cell_spec, load_module  # noqa: E402
from benchmark.reference.network import bf16_quant  # noqa: E402

def half(batches: list) -> list:
    """Each batch's first half of the sequences, weighted twice."""
    out = []
    for b in batches:
        h = b["features"].shape[0] // 2
        out.append({"features": b["features"][:h],
                    "ivectors": b["ivectors"][:h],
                    "weights": b["weights"][:h] * 2.0,
                    "deriv_weights": b["deriv_weights"][:h],
                    "num": {k: v[:h] for k, v in b["num"].items()},
                    "left_context": b["left_context"]})
    return out


def values(prog, ref) -> dict:
    """The compared numbers, and beside them the ones left out."""
    out, info = tr.gaps(prog, ref)
    out.update(info)
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    spec = cell_spec(args.workload, Path(os.environ.get("BENCH_ROOT", ROOT)))
    driver = load_module(ROOT / "benchmark" / "drivers"
                         / f"{spec['cell']['driver']}.py", "driver")
    if spec["cell"]["driver"] == "recipe":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    shared = driver.prepare(spec, device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fast = None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        workdir = tempfile.mkdtemp(prefix="bench_cal_")
        try:
            r = driver.Run(shared, spec, seed, device, workdir)
            prog = r.first_steps()
            weights, batches, lrs, mask_seed = r.reference_inputs()
            r.close()
            del r
            tr.free_device(device)
            ref = tr.reference_readings(spec, weights, batches, lrs,
                                        mask_seed, device)
            x = prog["chain"]["x"]
            ref["chain"] = tr.chain_reference(spec, x, batches[0], device)
            row = {"seed": seed, "program": values(prog, ref),
                   "skipped": prog["skipped"]}
            if seed in controls:
                ctl = tr.reference_readings(spec, weights, batches, lrs,
                                            mask_seed, device, control=True)
                row["control"] = values(ctl, ref)
                hb = tr.reference_readings(spec, weights, half(batches), lrs,
                                           mask_seed, device)
                row["half_batch"] = values(hb, ref)
                bf = tr.reference_readings(spec, weights, batches, lrs,
                                           mask_seed, device,
                                           quant=bf16_quant)
                row["bf16_reference"] = values(bf, ref)
                if fast is None:
                    fast = tr.port_den(spec, device, mode="fast")
                row["chain_control"] = tr.chain_gaps(
                    tr.chain_control(spec, x, batches[0], device, fast),
                    ref["chain"])
                lr2 = tr.reference_readings(spec, weights, batches,
                                            [2.0 * v for v in lrs],
                                            mask_seed, device)
                row["lr_doubled"] = values(lr2, ref)
                if spec["cell"]["momentum"] > 0:
                    still = dict(spec, cell=dict(spec["cell"], momentum=0.0))
                    m0 = tr.reference_readings(still, weights, batches, lrs,
                                               mask_seed, device)
                    row["momentum_ignored"] = values(m0, ref)
            row["s"] = time.time() - t0
            print(json.dumps(row), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            tr.free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
