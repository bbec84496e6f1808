"""Driver of the bidirectional step cells: bench.py's train step on a model
whose fast-lstmp layers walk both ways in time (the TDNN-BLSTM), on
batches made on the device.

drivers/step_recurrent.py's loop, record and checks (its `Run`, batches,
probe and readings are taken from there), with what a reverse walk needs
beside them: the chunk's right context (the cell's `frames_in` holds it
after the supervised span; `left_context` is the left's), the plain
reference of reference/tdnn_blstm.py, the counts of counts/blstm.py, and a
check that every window step launches the recurrence kernel once a layer
and pass, the reverse walks' launches among them
(`lstmp_recurrence.reverse_launches`), also where the step replays a CUDA
graph.

The recurrence probe is the program's first reverse recurrence in step 1
(its first fast-lstmp layer with a positive delay), compared as
step_recurrent compares the first forward one: `lstmp_probe_gap` in the
cell's bf16 mode under `probe_limit`, `lstmp_probe_gap_fp32` in float32
under `probe_limit_fp32`.

The record holds `lstmp_bound` (the forward walks' least time a step and
launches, which `lstmp_roofline_pct` reads) and `lstmp_reverse_bound` (the
reverse walks', which `lstmp_reverse_roofline_pct` reads).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.counts.blstm import bound, step_flops
from benchmark.counts.den_scan import den_flops
from benchmark.drivers import step_recurrent as rec
from benchmark.drivers.step_recurrent import (  # noqa: F401  (the driver API)
    _grads, _port_graph, batches_of, bf16_operand, capture_probe, prepare,
    probe_gap, probe_gaps,
)
from benchmark.harness import training as tr
from benchmark.harness.trace import Tracer
from benchmark.reference import tdnn_blstm as ref


def ref_model(spec: dict) -> ref.RModel:
    return ref.load(tr.xconfig_path(spec))


def launches() -> tuple:
    """The program's counts of recurrence kernel launches, (all, reverse
    walks); 0 where it has no such count."""
    try:
        from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    except ImportError:
        return 0, 0
    return (lstmp_recurrence.launches,
            getattr(lstmp_recurrence, "reverse_launches", 0))


def layers_per_step(spec: dict) -> tuple:
    """Launches of the recurrence kernel a step, (all, reverse walks): one
    a layer and pass."""
    lstms = [l for l in ref_model(spec).layers
             if l.kind == "fast-lstmp-layer"]
    return 2 * len(lstms), 2 * sum(1 for l in lstms
                                   if int(l.opts.get("delay", -1)) > 0)


class Run(rec.Run):
    """step_recurrent's Run; its recurrence probe taps the first reverse
    walk of step 1."""

    def step(self):
        from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
        tap = lstmp_recurrence.tap
        if tap is None:
            return super().step()

        def reverse_only(*args):
            if getattr(args[5], "reverse", False):
                tap(*args)
        lstmp_recurrence.tap = reverse_only
        try:
            return super().step()
        finally:
            lstmp_recurrence.tap = tap


def reference_readings(spec: dict, weights: dict, batches: list, lrs: list,
                       device, quant=None, faults=()) -> dict:
    """The reference's readings of the first steps (float32 network,
    float64 chain), as step_recurrent reads them, through
    reference/tdnn_blstm.py; `faults` runs a faulted model."""
    cell = spec["cell"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = {"frame_subsampling_factor":
           spec["config"]["frame_subsampling_factor"],
           "momentum": cell["momentum"],
           "max_param_change": cell["max_param_change"],
           "l2": cell["l2_regularize"], "oor": cell["out_of_range_regularize"],
           "leaky": cell["leaky_hmm"],
           "xent_regularize": cell["xent_regularize"],
           "deriv_truncate_margin": cell["deriv_truncate_margin"]}
    out = ref.follow_steps(ref_model(spec), weights, batches,
                           tr.ref_den(spec, device), cfg, lrs, quant=quant,
                           faults=faults)
    keys = tr.leaf_keys(weights)
    return {"loss": out["loss"], "num_lp": out["num_lp"],
            "den_lp": out["den_lp"], "outs": out["outs"],
            "grad1": {key: float(out["grad1"][key].norm()) for key in keys},
            "grad1_vec": {key: out["grad1"][key].detach().float().cpu()
                          for key in keys},
            "change": {(l, k): float((out["params"][l][k]
                                      - weights[l][k]).norm())
                       for l, k in keys},
            "delta": tr.param_deltas(out["params"], weights, keys)}


def probe_reference(spec: dict, probe: dict, faults=(), bf16=None) -> list:
    """The reference's reverse cell on the probe, in the frames the
    program's steps name (the layer's grid, the walk's first step, the
    derivative window and zeroing rows) and with its operands in bf16
    where the probe's are (`bf16` overrides): [r, m up to the walk's first
    step, and the leaves' gradients]."""
    leaves, steps = probe["leaves"], probe["steps"]
    bf = steps.bf16_ops if bf16 is None else bf16
    lstm = next(l for l in ref_model(spec).layers
                if l.kind == "fast-lstmp-layer"
                and int(l.opts.get("delay", -1)) > 0)
    fs, s0 = steps.frame_step, steps.start
    if not steps.reverse or steps.delay * fs != ref.cell_of(lstm).delay:
        raise ValueError(f"the program's recurrence reads {steps.delay} "
                         f"steps of {fs} frames {'ahead' if steps.reverse else 'back'}; "
                         f"the layer's delay is {ref.cell_of(lstm).delay}")
    quant = bf16_operand if bf else None
    window = (steps.frame0 + fs * steps.deriv_lo,
              steps.frame0 + fs * steps.deriv_hi)
    cell = spec["cell"]
    last_sup = (cell["frames_out"] - 1) * spec["config"][
        "frame_subsampling_factor"]

    def run(z, w_r, peep, w_rr, b_r):
        r, m = ref.walk(lstm, z[:, :s0 + 1], w_r, peep, w_rr, b_r,
                        steps.frame0, steps.frame0 + fs * s0, 0, last_sup,
                        window, quant, faults, stride=fs)
        return r, m if quant is None else quant(m)
    torch.backends.cuda.matmul.allow_tf32 = False
    return _grads(leaves, run, probe["g_r"][:, :s0 + 1],
                  probe["g_m"][:, :s0 + 1])


def probe_program(probe: dict, bf16=None) -> list:
    """The program's recurrence (its kernel on a card) on the probe, in
    the probe's steps (`bf16` overrides bf16_ops), cut as
    probe_reference's."""
    from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    steps = probe["steps"]
    if bf16 is not None:
        steps = dataclasses.replace(steps, bf16_ops=bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _grads(probe["leaves"], lambda *xs: lstmp_recurrence(*xs, steps),
                 probe["g_r"], probe["g_m"])
    return [out[0][:, :steps.start + 1], out[1][:, :steps.start + 1]] \
        + out[2:]


def _shape(spec: dict) -> tuple:
    cell, cfg = spec["cell"], spec["config"]
    return (ref_model(spec), cell["batch"], cell["frames_in"],
            cfg["frame_subsampling_factor"], cell["left_context"])


def flops_per_step(spec: dict) -> float:
    cell, cfg = spec["cell"], spec["config"]
    den = cfg["den"]
    return (step_flops(*_shape(spec))
            + den_flops(den["chains"], den["states_per_phone"], cell["batch"],
                        cell["frames_out"], den["states"], cfg["pdfs"]))


def run(spec: dict, args, device, t_start: float) -> dict:
    cell = spec["cell"]
    shared = prepare(spec, device)
    r = Run(shared, spec, args.seed, device)
    prog = r.first_steps()
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    per_step = layers_per_step(spec) if device.type == "cuda" else (0, 0)

    tracer = Tracer(device) if args.trace else None
    if tracer:
        tracer.warm_up()
    losses, skips, counts = [], [], []
    host = tr.HostLog()
    tr.sync(device)
    t0 = time.perf_counter()
    host.start(t0)
    deadline = t0 + args.seconds
    n = 0
    while time.perf_counter() < deadline:
        before = launches()
        with torch.profiler.record_function("bench.step"):
            out = r.step()
        counts.append(tuple(a - b for a, b in zip(launches(), before)))
        losses.append(out.loss)
        skips.append(out.skipped)
        n += 1
        host.mark()
    tr.sync(device)
    t1 = time.perf_counter()
    host.stop()
    if any(c != per_step for c in counts):
        raise RuntimeError(f"a window step launched the recurrence kernel "
                           f"(all, reverse) {sorted(set(counts))} times, not "
                           f"{per_step}")
    if tracer:
        # the traced span follows the window, as step_recurrent's does
        tracer.start()
        for _ in range(cell["trace_steps"]):
            with torch.profiler.record_function("bench.step"):
                out = r.step()
            losses.append(out.loss)
            skips.append(out.skipped)
        tracer.stop()
    vals = tr.as_list(losses + skips)
    total = len(losses)
    failed = sum(1 for l, s in zip(vals[:total], vals[total:])
                 if s != 0 or not tr.finite([l])[0])
    rec_ = {"setup_s": setup_s, "window_s": t1 - t0, "steps": n,
            "audio_s": n * cell["batch"] * cell["frames_out"]
            * spec["config"]["frame_subsampling_factor"] / 100.0,
            "attempted": total, "failed": failed,
            "memory_peak_bytes": tr.memory_peak(device),
            "flops_per_step": flops_per_step(spec),
            "traced_steps": cell["trace_steps"] if tracer else 0,
            "den_scan_bound": tr.den_scan_bound(spec),
            "lstmp_bound": bound(*_shape(spec), reverse=False),
            "lstmp_reverse_bound": bound(*_shape(spec), reverse=True),
            "launches_per_step": list(per_step), "trace": None,
            "host": host.summary()}
    if tracer:
        rec_["trace"] = tracer.summary()
    from benchmark.harness.core import power_limit
    rec_["power_limit"] = power_limit() if device.type == "cuda" else None

    weights, batches, lrs = r.reference_inputs()
    probe = r.probe
    del r, shared, losses, skips, out
    tr.free_device(device)
    refs = reference_readings(spec, weights, batches, lrs, device)
    refs["chain"] = tr.chain_reference(spec, prog["chain"]["x"], batches[0],
                                       device)
    rec_["checks"], rec_["correct"], rec_["check_info"] = tr.compare(
        prog, refs, cell["limits"])
    del refs
    tr.free_device(device)
    for name, bf16, limit in (
            ("lstmp_probe_gap", None, cell["probe_limit"]),
            ("lstmp_probe_gap_fp32", False, cell["probe_limit_fp32"])):
        gap = probe_gap(probe_program(probe, bf16),
                        probe_reference(spec, probe, bf16=bf16))
        rec_["checks"].append({"name": name, "value": gap, "limit": limit})
        rec_["correct"] = rec_["correct"] and gap <= limit
    if any(s != 0 for s in prog.get("skipped", [])):
        rec_["correct"] = False
    return rec_
