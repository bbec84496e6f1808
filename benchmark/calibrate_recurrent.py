"""Readings from which a recurrent step cell's correctness limits are set
(calibrate.py's readings for the `step_recurrent` driver, whose reference
is reference/tdnn_lstm.py).

  python benchmark/calibrate_recurrent.py --workload tdnn_lstm.step \\
      --seeds 1,2,3 [--control-seeds 1]

In one process, for each seed: the program's first steps against the
reference's (the sound reading), and for each control seed, against the
reference:

- control: the reference with every matrix product's operands in float8
  (the network's numbers), in the program's place;
- chain_control: the program's bf16 den and a bf16 numerator on the
  program's own step-1 output (the chain's numbers);
- the faults the limits must catch, each the reference run with it:
  bf16_c (the cell state in bf16), s1 (no decay scale), no_peephole,
  no_delay (output-delay 0), read on the train step's numbers and on the
  recurrence probe (`lstmp_probe_gap` and `lstmp_probe_gap_fp32`: the
  faulted reference cell against the sound one, in the cell's own mode
  and in float32);
- bf16_reference: a witness, the reference with its operands in bf16.

One JSON line per seed; no timing.  Needs the cell's card.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import training as tr  # noqa: E402
from benchmark.harness.core import cell_spec, load_module  # noqa: E402
from benchmark.reference.network import bf16_quant, fp8_quant  # noqa: E402

FAULTS = ("bf16_c", "s1", "no_peephole", "no_delay")
# the recurrence probe's readings: in the cell's own mode, and in float32
PROBES = (("lstmp_probe_gap", None), ("lstmp_probe_gap_fp32", False))


def values(prog, ref) -> dict:
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
    drv = load_module(ROOT / "benchmark" / "drivers"
                      / f"{spec['cell']['driver']}.py", "driver")
    shared = drv.prepare(spec, device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fast = None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        r = drv.Run(shared, spec, seed, device)
        prog = r.first_steps()
        probe = r.probe
        weights, batches, lrs = r.reference_inputs()
        del r
        tr.free_device(device)
        ref = drv.reference_readings(spec, weights, batches, lrs, device)
        x = prog["chain"]["x"]
        ref["chain"] = tr.chain_reference(spec, x, batches[0], device)
        row = {"seed": seed, "program": values(prog, ref),
               "skipped": prog["skipped"]}
        sound = {}
        for name, bf16 in PROBES:
            sound[name] = drv.probe_reference(spec, probe, bf16=bf16)
            row[name] = drv.probe_gaps(drv.probe_program(probe, bf16),
                                       sound[name])
            row["program"][name] = max(row[name].values())
        if seed in controls:
            ctl = drv.reference_readings(spec, weights, batches, lrs, device,
                                         quant=fp8_quant)
            row["control"] = values(ctl, ref)
            bf = drv.reference_readings(spec, weights, batches, lrs, device,
                                        quant=bf16_quant)
            row["bf16_reference"] = values(bf, ref)
            for fault in FAULTS:
                bad = drv.reference_readings(spec, weights, batches, lrs,
                                             device, faults=(fault,))
                row[fault] = values(bad, ref)
                for name, bf16 in PROBES:
                    row[fault][name] = drv.probe_gap(drv.probe_reference(
                        spec, probe, (fault,), bf16), sound[name])
            if fast is None:
                fast = tr.port_den(spec, device, mode="fast")
            row["chain_control"] = tr.chain_gaps(
                tr.chain_control(spec, x, batches[0], device, fast),
                ref["chain"])
        row["s"] = time.time() - t0
        print(json.dumps(row), flush=True)
        tr.free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
