"""Driver of the step cells: bench.py's train step on batches made on the
device.

The program's `make_train_step` (SGD with momentum, no NG, no xent, no
loss scaling, the structured den on the fused scans) steps through the
cell's `batches` batches in turn.  Set-up builds the den and the step,
puts the seed's weights into the network, and takes `warmup_steps` steps
through the window's own call: the first three are the ones the reference
follows.  The window then steps until `--seconds` have passed; a traced
run then traces `trace_steps` more.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import training as tr
from benchmark.harness.trace import Tracer
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
        config = TrainConfig(
            learning_rate=cell["learning_rate"], momentum=cell["momentum"],
            max_param_change=cell["max_param_change"],
            frame_subsampling_factor=cfg["frame_subsampling_factor"],
            left_context=cell["left_context"],
            compute_dtype=cfg["compute_dtype"])
        model = shared["model"]
        self.net, self.opt, self.scale = init_train_state(
            model, torch.Generator().manual_seed(0), config, device)
        self.weights = tr.seed_weights(spec, sub_seed(seed, "weights"),
                                       device)
        tr.load_weights(self.net.params, self.weights)
        self.den = shared["den"]
        self.step_fn = make_train_step(
            model, self.net, self.den, None,
            ChainTrainingOpts(
                l2_regularize=cell["l2_regularize"],
                out_of_range_regularize=cell["out_of_range_regularize"],
                leaky_hmm_coefficient=cell["leaky_hmm"]),
            config, num_frames_out=cell["frames_out"])
        self.use_loss_scaling = config.use_loss_scaling
        self.batches = batches_of(spec, seed, device, cell["batches"])
        self.graphs = [_port_graph(b["num"], device) for b in self.batches]
        self.mask_seed = sub_seed(seed, "masks")
        self.gen = torch.Generator(device=device).manual_seed(self.mask_seed)
        self.k = 0

    def step(self):
        b = self.batches[self.k % len(self.batches)]
        arrays = {n: b[n] for n in ("features", "ivectors", "weights",
                                    "deriv_weights")}
        self.opt, self.scale, out = self.step_fn(
            self.opt, self.scale, arrays, generator=self.gen,
            num_graph=self.graphs[self.k % len(self.batches)],
            left_context=b["left_context"])
        self.k += 1
        return out

    def first_steps(self) -> dict:
        """The program's readings of steps 1-3, then the rest of the
        warm-up."""
        keys = tr.leaf_keys(self.weights)
        tap = tr.OutputTap(self.net)
        chain = tr.ChainTap(self.den)
        scale = float(self.scale.scale) if self.use_loss_scaling else 1.0
        outs = [self.step()]
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
                "grad1_vec": grad1_vec, "delta": delta, "outs": tap.outs,
                "chain": chain.readings(scale, vals[1][0])}

    def reference_inputs(self) -> tuple:
        """(weights, batches, learning rates, SpecAugment seed) of the
        steps the reference follows."""
        return (self.weights, self.batches[:tr.CHECK_STEPS],
                [self.spec["cell"]["learning_rate"]] * tr.CHECK_STEPS,
                self.mask_seed)

    def close(self) -> None:
        pass


def run(spec: dict, args, device, t_start: float) -> dict:
    cell = spec["cell"]
    shared = prepare(spec, device)
    r = Run(shared, spec, args.seed, device)
    prog = r.first_steps()
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    tracer = Tracer(device) if args.trace else None
    if tracer:
        tracer.warm_up()
    losses, skips = [], []
    host = tr.HostLog()
    tr.sync(device)
    t0 = time.perf_counter()
    host.start(t0)
    deadline = t0 + args.seconds
    n = 0
    while time.perf_counter() < deadline:
        with torch.profiler.record_function("bench.step"):
            out = r.step()
        losses.append(out.loss)
        skips.append(out.skipped)
        n += 1
        host.mark()
    tr.sync(device)
    t1 = time.perf_counter()
    host.stop()
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
           "flops_per_step": tr.flops_per_step(spec, cell["frames_in"], False),
           "traced_steps": cell["trace_steps"] if tracer else 0,
           "den_scan_bound": tr.den_scan_bound(spec), "trace": None,
           "host": host.summary()}
    if tracer:
        rec["trace"] = tracer.summary()
    from benchmark.harness.core import power_limit
    rec["power_limit"] = power_limit() if device.type == "cuda" else None

    weights, batches, lrs, mask_seed = r.reference_inputs()
    del r, shared, losses, skips, out
    tr.free_device(device)
    ref = tr.reference_readings(spec, weights, batches, lrs, mask_seed,
                                device)
    ref["chain"] = tr.chain_reference(spec, prog["chain"]["x"], batches[0],
                                      device)
    rec["checks"], rec["correct"], rec["check_info"] = tr.compare(
        prog, ref, cell["limits"])
    if any(s != 0 for s in prog.get("skipped", [])):
        rec["correct"] = False
    return rec
