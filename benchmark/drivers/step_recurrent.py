"""Driver of the recurrent step cells: bench.py's train step on a model with
fast-lstmp layers (the TDNN-LSTM), on batches made on the device.

drivers/step.py's loop, record and checks, with what a recurrent model
needs beside them: the chunk's extra left context (the cell's
`left_context` holds it), the derivative window (`deriv_truncate_margin`),
the plain reference of reference/tdnn_lstm.py, the counts of
counts/lstmp.py, and a check that every window step launches the
recurrence kernel once a layer and pass (`lstmp_recurrence.launches`).

Beside the train step's numbers the cell compares the recurrence alone:
the program's first recurrence in step 1 (its first fast-lstmp layer's
inputs, weights and steps, as the program passed them to
`lstmp_recurrence`), with derivatives of r and m drawn from the seed,
large enough to clip and zero, forward and backward, against the
reference's cell on the same inputs, in the frames, window and zeroing
rows the steps name.  `lstmp_probe_gap` runs it in the cell's own mode
(bf16 operands; the reference rounds the same operands and keeps its
state and sums in float32), under the cell's `probe_limit`;
`lstmp_probe_gap_fp32` runs both in float32, under `probe_limit_fp32`,
where only the order of float32 sums parts them.  With random weights a
cell state held in bf16 moves the network's outputs less than the
program's own bf16 operands do; on the probe it reads 4x the sound
runs' gap in the cell's mode and thousands of times it in float32.

The program's `make_train_step` (SGD with momentum, no NG, no xent, no
loss scaling, the structured den on the fused scans) steps through the
cell's `batches` batches in turn; set-up takes `warmup_steps` steps, the
first three of which the reference follows.  The outputs compared are the
chain and xent heads at the supervised frames.
"""

from __future__ import annotations

import time

import torch

from benchmark.counts.den_scan import den_flops
from benchmark.counts.lstmp import recurrences, step_flops
from benchmark.harness import training as tr
from benchmark.harness.trace import Tracer
from benchmark.reference import tdnn_lstm as ref
from benchmark.traffic.seeds import sub_seed
from benchmark.traffic.step_batches import make_batch


def _port_graph(num: dict, device):
    from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch
    ints = ("arc_src", "arc_dst", "arc_pdf", "start")
    t = {k: torch.as_tensor(v, device=device,
                            dtype=torch.int32 if k in ints else torch.float32)
         for k, v in num.items()}
    return NumeratorGraphBatch(**t, num_states=t["final_logw"].shape[1],
                               num_arcs=t["arc_src"].shape[1])


def ref_model(spec: dict) -> ref.RModel:
    return ref.load(tr.xconfig_path(spec))


def prepare(spec: dict, device) -> dict:
    """What does not depend on the seed: the model and the den."""
    from kaldi_fp16_tpu_torch.models.model import build_model
    return {"model": build_model(tr.xconfig_path(spec)),
            "den": tr.port_den(spec, device)}


def batches_of(spec: dict, seed: int, device, count: int) -> list:
    cell, cfg = spec["cell"], spec["config"]
    return [make_batch(seed, k, cell["batch"], cell["frames_in"],
                       cell["frames_out"], cfg["pdfs"], cfg["feat_dim"],
                       cfg["ivector_dim"], cell["left_context"],
                       cfg["frame_subsampling_factor"], device)
            for k in range(count)]


def launches() -> int:
    """The program's count of recurrence kernel launches (0 where it has
    no such kernel)."""
    try:
        from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    except ImportError:
        return 0
    return lstmp_recurrence.launches


def layers_per_step(spec: dict) -> int:
    """Launches of the recurrence kernel a step: one a layer and pass."""
    return 2 * sum(1 for l in ref_model(spec).layers
                   if l.kind == "fast-lstmp-layer")


class Run:
    """The program's step, its state and its feed for one seed."""

    def __init__(self, shared: dict, spec: dict, seed: int, device,
                 workdir=None):
        from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
        from kaldi_fp16_tpu_torch.training.train_step import (
            TrainConfig, init_train_state, make_train_step,
        )
        cell, cfg = spec["cell"], spec["config"]
        self.device = device
        self.spec = spec
        self.seed = seed
        config = TrainConfig(
            learning_rate=cell["learning_rate"], momentum=cell["momentum"],
            max_param_change=cell["max_param_change"],
            frame_subsampling_factor=cfg["frame_subsampling_factor"],
            left_context=cell["left_context"],
            compute_dtype=cfg["compute_dtype"],
            deriv_truncate_margin=cell["deriv_truncate_margin"])
        model = shared["model"]
        self.net, self.opt, self.scale = init_train_state(
            model, torch.Generator().manual_seed(0), config, device)
        self.weights = ref.make_weights(ref_model(spec),
                                        sub_seed(seed, "weights"), device)
        tr.load_weights(self.net.params, self.weights)
        self.den = shared["den"]
        self.step_fn = make_train_step(
            model, self.net, self.den, None,
            ChainTrainingOpts(
                l2_regularize=cell["l2_regularize"],
                out_of_range_regularize=cell["out_of_range_regularize"],
                leaky_hmm_coefficient=cell["leaky_hmm"]),
            config, num_frames_out=cell["frames_out"])
        self.batches = batches_of(spec, seed, device, cell["batches"])
        self.graphs = [_port_graph(b["num"], device) for b in self.batches]
        self.k = 0

    def step(self):
        b = self.batches[self.k % len(self.batches)]
        arrays = {n: b[n] for n in ("features", "ivectors", "weights",
                                    "deriv_weights")}
        self.opt, self.scale, out = self.step_fn(
            self.opt, self.scale, arrays,
            num_graph=self.graphs[self.k % len(self.batches)],
            left_context=b["left_context"])
        self.k += 1
        return out

    def supervised(self, outs: dict) -> dict:
        """The heads' outputs at the supervised frames (the grid's)."""
        cell = self.spec["cell"]
        s = cell["left_context"] // self.spec["config"][
            "frame_subsampling_factor"]
        return {k: v[:, s:s + cell["frames_out"]] for k, v in outs.items()}

    def first_steps(self) -> dict:
        """The program's readings of steps 1-3, then the rest of the
        warm-up; the recurrence probe of step 1 is kept as `probe`."""
        keys = tr.leaf_keys(self.weights)
        tap = tr.OutputTap(self.net)
        chain = tr.ChainTap(self.den)
        out, self.probe = capture_probe(self.step, self.seed, self.device)
        if self.probe is None:
            raise RuntimeError("the program's lstmp_recurrence has no tap: "
                               "the recurrence probe cannot be read")
        outs = [out]
        structured = self.den._structured
        if self.device.type == "cuda" and (
                structured is None or structured.scan_used != "fused"):
            raise RuntimeError("the step cells need the structured den on "
                               "the fused scans; the den took "
                               f"{self.den.layout_used} / "
                               f"{structured and structured.scan_used}")
        grad1 = tr.leaf_norms(self.opt["velocity"], keys)
        grad1_vec = tr.host_leaves(self.opt["velocity"], keys)
        outs += [self.step() for _ in range(tr.CHECK_STEPS - 1)]
        params = self.net.params
        with torch.no_grad():
            change = dict(zip(keys, torch.stack(
                [(params[l][k] - self.weights[l][k]).norm()
                 for l, k in keys]).tolist()))
        delta = tr.param_deltas(params, self.weights, keys)
        vals = tr.as_list([x for o in outs for x in
                           (o.loss, o.num_logprob, o.den_logprob, o.skipped)])
        vals = [vals[i::4] for i in range(4)]
        for _ in range(self.spec["cell"]["warmup_steps"] - tr.CHECK_STEPS):
            self.step()
        tr.sync(self.device)
        return {"loss": vals[0], "num_lp": vals[1], "den_lp": vals[2],
                "skipped": vals[3], "grad1": grad1, "change": change,
                "grad1_vec": grad1_vec, "delta": delta,
                "outs": self.supervised(tap.outs),
                "chain": chain.readings(1.0, vals[1][0])}

    def reference_inputs(self) -> tuple:
        """(weights, batches, learning rates) of the steps the reference
        follows."""
        return (self.weights, self.batches[:tr.CHECK_STEPS],
                [self.spec["cell"]["learning_rate"]] * tr.CHECK_STEPS)

    def close(self) -> None:
        pass


def reference_readings(spec: dict, weights: dict, batches: list, lrs: list,
                       device, quant=None, faults=()) -> dict:
    """The reference's readings of the first steps (float32 network,
    float64 chain), read as training.reference_readings reads them;
    `quant` rounds its operands (the control), `faults` runs a faulted
    model (reference/tdnn_lstm.py)."""
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


PROBE_NAMES = ("r", "m", "dz", "dw_r", "dpeephole", "dw_rr", "db_r")


def capture_probe(step, seed: int, device):
    """step()'s result and the probe: the program's first recurrence in
    that step (its first fast-lstmp layer), its arguments as the program
    passed them (`lstmp_recurrence.tap`: z, w_r, peephole, w_rr, b_r in
    float32, and the steps, bf16_ops as the cell runs), with derivatives
    of r and m drawn from the seed, large enough to clip and zero.  The
    probe is None where the program has no tap."""
    try:
        from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    except ImportError:
        return step(), None
    seen = []

    def tap(*args):
        if not seen:
            seen.append(([a.detach().float().clone() for a in args[:5]],
                         args[5]))
    lstmp_recurrence.tap = tap
    try:
        out = step()
    finally:
        lstmp_recurrence.tap = None
    if not seen:
        return out, None
    leaves, steps = seen[0]
    B, T, G = leaves[0].shape
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "probe"))
    g_r = torch.randn((B, T, leaves[1].shape[0]), generator=gen,
                      device=device) * 3.0
    g_m = torch.randn((B, T, G // 4), generator=gen, device=device) * 3.0
    return out, {"leaves": leaves, "steps": steps, "g_r": g_r, "g_m": g_m}


def _grads(leaves, run, g_r, g_m) -> list:
    xs = [x.clone().requires_grad_(True) for x in leaves]
    r, m = run(*xs)
    torch.autograd.backward([r, m], [g_r, g_m])
    return [r.detach(), m.detach()] + [x.grad for x in xs]


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept float32; the derivative passes unrounded
    (the program's bf16 operands, whose derivatives are float32)."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def probe_reference(spec: dict, probe: dict, faults=(), bf16=None) -> list:
    """The reference's cell on the probe, in the frames the program's
    steps name (the layer's grid, its first state, its derivative window
    and zeroing rows) and with its operands in bf16 where the probe's are
    (`bf16` overrides): [r, m from the first state on, and the leaves'
    gradients]."""
    leaves, steps = probe["leaves"], probe["steps"]
    bf = steps.bf16_ops if bf16 is None else bf16
    lstm = next(l for l in ref_model(spec).layers
                if l.kind == "fast-lstmp-layer")
    cell = ref.cell_of(lstm, faults)
    s0, fs = steps.start, steps.frame_step
    if steps.delay * fs != -cell.delay:
        raise ValueError(f"the program's recurrence reads {steps.delay} "
                         f"steps of {fs} frames back; the layer's delay is "
                         f"{cell.delay}")
    R = leaves[1].shape[0]
    quant = bf16_operand if bf else None
    window = (steps.frame0 + fs * steps.deriv_lo,
              steps.frame0 + fs * steps.deriv_hi)

    def run(z, w_r, peep, w_rr, b_r):
        r, m = ref.recurrence(z[:, s0:], w_r, peep, w_rr, b_r, R,
                              steps.frame0 + fs * s0, cell, 0, window, quant,
                              faults, stride=fs)
        return r, m if quant is None else quant(m)
    torch.backends.cuda.matmul.allow_tf32 = False
    return _grads(leaves, run, probe["g_r"][:, s0:], probe["g_m"][:, s0:])


def probe_program(probe: dict, bf16=None) -> list:
    """The program's recurrence (its kernel on a card) on the probe, in
    the probe's steps (`bf16` overrides bf16_ops), cut as
    probe_reference's."""
    import dataclasses
    from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    steps = probe["steps"]
    if bf16 is not None:
        steps = dataclasses.replace(steps, bf16_ops=bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _grads(probe["leaves"], lambda *xs: lstmp_recurrence(*xs, steps),
                 probe["g_r"], probe["g_m"])
    return [out[0][:, steps.start:], out[1][:, steps.start:]] + out[2:]


def probe_gaps(got: list, want: list) -> dict:
    """||got - want|| / ||want|| of r, m and each gradient."""
    return {n: float((a.double() - b.double()).norm()
                     / b.double().norm().clamp(min=1e-30))
            for n, a, b in zip(PROBE_NAMES, got, want)}


def probe_gap(got: list, want: list) -> float:
    """The largest of probe_gaps."""
    return max(probe_gaps(got, want).values())


def flops_per_step(spec: dict) -> float:
    cell, cfg = spec["cell"], spec["config"]
    den = cfg["den"]
    return (step_flops(ref_model(spec), cell["batch"], cell["frames_in"],
                       cfg["frame_subsampling_factor"], cell["left_context"])
            + den_flops(den["chains"], den["states_per_phone"], cell["batch"],
                        cell["frames_out"], den["states"], cfg["pdfs"]))


def lstmp_bound(spec: dict) -> dict:
    """The recurrence kernels' least time a step on the card, and their
    launches a step."""
    cell, cfg = spec["cell"], spec["config"]
    work = recurrences(ref_model(spec), cell["batch"], cell["frames_in"],
                       cfg["frame_subsampling_factor"], cell["left_context"])
    return {"bound_s_per_step": sum(w["forward"]["bound_s"]
                                    + w["backward"]["bound_s"]
                                    for _, _, w in work),
            "launches_per_step": 2 * len(work),
            "steps": [n for _, n, _ in work]}


def run(spec: dict, args, device, t_start: float) -> dict:
    cell = spec["cell"]
    shared = prepare(spec, device)
    r = Run(shared, spec, args.seed, device)
    prog = r.first_steps()
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    per_step = layers_per_step(spec) if device.type == "cuda" else 0

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
        counts.append(launches() - before)
        losses.append(out.loss)
        skips.append(out.skipped)
        n += 1
        host.mark()
    tr.sync(device)
    t1 = time.perf_counter()
    host.stop()
    if any(c != per_step for c in counts):
        raise RuntimeError(f"a window step launched the recurrence kernel "
                           f"{sorted(set(counts))} times, not {per_step}")
    if tracer:
        # the traced span follows the window, so that the window runs as an
        # untraced run's does: the profiler slows the host's side of a step
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
    rec = {"setup_s": setup_s, "window_s": t1 - t0, "steps": n,
           "audio_s": n * cell["batch"] * cell["frames_out"]
           * spec["config"]["frame_subsampling_factor"] / 100.0,
           "attempted": total, "failed": failed,
           "memory_peak_bytes": tr.memory_peak(device),
           "flops_per_step": flops_per_step(spec),
           "traced_steps": cell["trace_steps"] if tracer else 0,
           "den_scan_bound": tr.den_scan_bound(spec),
           "lstmp_bound": lstmp_bound(spec), "trace": None,
           "host": host.summary()}
    if tracer:
        rec["trace"] = tracer.summary()
    from benchmark.harness.core import power_limit
    rec["power_limit"] = power_limit() if device.type == "cuda" else None

    weights, batches, lrs = r.reference_inputs()
    probe = r.probe
    del r, shared, losses, skips, out
    tr.free_device(device)
    refs = reference_readings(spec, weights, batches, lrs, device)
    refs["chain"] = tr.chain_reference(spec, prog["chain"]["x"], batches[0],
                                       device)
    rec["checks"], rec["correct"], rec["check_info"] = tr.compare(
        prog, refs, cell["limits"])
    del refs
    tr.free_device(device)
    for name, bf16, limit in (
            ("lstmp_probe_gap", None, cell["probe_limit"]),
            ("lstmp_probe_gap_fp32", False, cell["probe_limit_fp32"])):
        gap = probe_gap(probe_program(probe, bf16),
                        probe_reference(spec, probe, bf16=bf16))
        rec["checks"].append({"name": name, "value": gap, "limit": limit})
        rec["correct"] = rec["correct"] and gap <= limit
    if any(s != 0 for s in prog.get("skipped", [])):
        rec["correct"] = False
    return rec
