"""Driver of the recipe cells: configs/train_flagship.sh's job.

Set-up draws the cell's cegs from the seed (traffic/egs.py) and writes them
as Kaldi ark files under TMPDIR with the port's writer, builds a Trainer
configured as `tools.train` configures it for the cell's flags, puts the
seed's weights into its network, and feeds `Trainer.train_epoch` from the
port's DataLoader (native parser, prefetch thread).  An epoch lists each
ark file `egs_repeats` times, so it is long (as a real epoch is, tens of
thousands of steps) next to the window: the shuffle buffer fills once, in
set-up, and the loader parses every batch it hands out.  The learning-rate
schedule spans `schedule_egs_per_epoch` examples an epoch, the recipe's
real data.  The first `warmup_steps` steps run through that feed: the first
three are the ones the reference follows.  The window then trains until
`--seconds` have passed; a traced run then traces `trace_steps` more.

The benchmark's wrapper around the batches times each `__next__` on the
host (loader_wait_ms) and records a CUDA event as each batch is pulled
(the steps' device-timeline times, ng_update_extra_ms).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import training as tr
from benchmark.harness.trace import Tracer
from benchmark.reference.cm import cm2_round_trip, cm_round_trip
from benchmark.reference.train import recipe_lr
from benchmark.traffic.egs import make_examples, numerator_arrays
from benchmark.traffic.seeds import sub_seed


def _examples(spec: dict, seed: int) -> list:
    cell, cfg = spec["cell"], spec["config"]
    return make_examples(sub_seed(seed, "egs"), cell["egs"],
                         cell["frames_in"], cell["frames_out"], cfg["pdfs"],
                         cfg["feat_dim"], cfg["ivector_dim"],
                         cell["left_context"])


def write_egs(examples: list, outdir: str, per_file: int, pdfs: int) -> list:
    """The examples as cegs ark files (features "CM", ivector "CM2"),
    written with the port's writer, as tools.make_synthetic_egs does."""
    from kaldi_fp16_tpu_torch.io.egs import (
        Example, Index, IoBlock, Supervision, write_ark,
    )
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    from benchmark.traffic.egs import ALT_WEIGHT
    files = []
    for f in range(0, len(examples), per_file):
        exs = []
        for ex in examples[f:f + per_file]:
            n, left, stride = len(ex["pdfs"]), ex["left"], ex["stride"]
            states = [FstState() for _ in range(n + 1)]
            for i, (p, alt) in enumerate(zip(ex["pdfs"].tolist(),
                                             ex["alts"].tolist())):
                states[i].arcs.append(FstArc(p, 0.0, i + 1))
                if alt != p:
                    states[i].arcs.append(FstArc(alt, ALT_WEIGHT, i + 1))
            states[-1].final = 0.0
            T = ex["features"].shape[0]
            exs.append(Example(
                key=ex["key"],
                inputs=[IoBlock("input", [Index(0, t - left, 0)
                                          for t in range(T)],
                                ex["features"], "CM"),
                        IoBlock("ivector", [Index(0, 0, 0)], ex["ivector"],
                                "CM2")],
                supervision=Supervision(
                    name="output", weight=1.0, num_sequences=1,
                    frames_per_seq=n, label_dim=pdfs, end2end=False,
                    fst=Fst(start=0, states=states),
                    indexes=[Index(0, i * stride, 0) for i in range(n)],
                    deriv_weights=np.ones(n, dtype=np.float32))))
        path = os.path.join(outdir, f"cegs.{f // per_file + 1}.ark")
        write_ark(path, exs)
        files.append(path)
    return files


class Feed:
    """The batches handed to Trainer.train_epoch: the DataLoader's over the
    files listed `egs_repeats` times, epoch after epoch (file order and the
    example buffer reshuffled with seed + epoch), behind a prefetch thread.
    `take(n)` gives n batches and stops; `until(t)` gives batches until the
    host clock passes t."""

    def __init__(self, files, cell: dict, config: dict, seed: int, device):
        self.files, self.cell, self.seed = files, cell, seed
        self.config = config
        self.device = device
        self.limit = None
        self.deadline = None
        self.keys = []
        self.waits, self.events = [], []
        self.pulls = 0
        self.record = False
        self.on_pull = None
        self._prefetch = None
        self._gen = self._batches()

    def _batches(self):
        from kaldi_fp16_tpu_torch.io.dataloader import (
            DataLoader, DataLoaderConfig, PrefetchLoader,
        )
        c = self.cell
        epoch = 0
        while True:
            cfg = DataLoaderConfig(
                batch_size=c["batch"], label_dim=self.config["pdfs"],
                feat_dim=self.config["feat_dim"],
                ivector_dim=self.config["ivector_dim"],
                shuffle_files=True, shuffle_buffer=c["shuffle_buffer"],
                seed=self.seed + epoch, max_fst_states=c["fst_pad_states"],
                max_fst_arcs=c["fst_pad_arcs"])
            self._prefetch = PrefetchLoader(
                DataLoader(self.files * c["egs_repeats"], cfg), c["prefetch"])
            n = 0
            for batch in self._prefetch:
                n += 1
                yield batch
            self._prefetch.close()
            if n == 0:
                raise RuntimeError("an epoch of the egs gave no batch")
            epoch += 1

    def take(self, n: int) -> "Feed":
        self.limit, self.deadline = n, None
        return self

    def until(self, deadline: float) -> "Feed":
        self.limit, self.deadline = None, deadline
        return self

    def __iter__(self):
        return self

    def __next__(self):
        if self.limit is not None:
            if self.limit <= 0:
                raise StopIteration
            self.limit -= 1
        if (self.deadline is not None
                and time.perf_counter() >= self.deadline):
            raise StopIteration
        if self.on_pull is not None:
            self.on_pull(self.pulls)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.loader_next"):
            batch = next(self._gen)
        wait = time.perf_counter() - t
        if self.record:
            self.waits.append(wait)
            if self.device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
        if len(self.keys) < tr.CHECK_STEPS:
            self.keys.append(list(batch.keys))
        self.pulls += 1
        return batch

    def close(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
        self._gen.close()


def port_schedule(cell: dict):
    """The program's learning-rate schedule, as tools.train builds it:
    exponential decay over the epochs' steps, linear warm-up first."""
    from kaldi_fp16_tpu_torch.training.schedulers import warmup_lr
    from kaldi_fp16_tpu_torch.training.trainer import exponential_lr
    total = max(cell["schedule_egs_per_epoch"] // cell["batch"]
                * cell["epochs"], 1)
    schedule = exponential_lr(cell["learning_rate"], cell["lr_final"], total)
    if cell["lr_warmup_steps"]:
        schedule = warmup_lr(schedule, cell["lr_warmup_steps"])
    return schedule


def prepare(spec: dict, device) -> dict:
    from kaldi_fp16_tpu_torch.models.model import build_model
    return {"model": build_model(tr.xconfig_path(spec)),
            "den": tr.port_den(spec, device)}


class Run:
    """A Trainer as tools.train builds it for the cell's flags, and its
    feed, for one seed."""

    def __init__(self, shared: dict, spec: dict, seed: int, device,
                 workdir: str):
        from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
        from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
        from kaldi_fp16_tpu_torch.training.trainer import Trainer
        cell, cfg = spec["cell"], spec["config"]
        self.spec, self.device = spec, device
        self.examples = _examples(spec, seed)
        files = write_egs(self.examples, workdir, cell["egs_per_file"],
                          cfg["pdfs"])
        config = TrainConfig(
            learning_rate=cell["learning_rate"], momentum=cell["momentum"],
            max_param_change=cell["max_param_change"],
            frame_subsampling_factor=cfg["frame_subsampling_factor"],
            xent_regularize=cell["xent_regularize"],
            natural_gradient=cell["natural_gradient"],
            ng_rank_in=cell["ng_rank_in"], ng_rank_out=cell["ng_rank_out"],
            orthonormal_interval=cell["orthonormal_interval"],
            use_loss_scaling=cell["loss_scaling"],
            compute_dtype=cfg["compute_dtype"])
        chain_opts = ChainTrainingOpts(
            l2_regularize=cell["l2_regularize"],
            out_of_range_regularize=cell["out_of_range_regularize"],
            leaky_hmm_coefficient=cell["leaky_hmm"],
            xent_regularize=cell["xent_regularize"])
        self.trainer_seed = sub_seed(seed, "trainer")
        self.trainer = Trainer(
            shared["model"], shared["den"], config, chain_opts,
            lr_schedule=port_schedule(cell), seed=self.trainer_seed,
            device=device)
        self.weights = tr.seed_weights(spec, sub_seed(seed, "weights"),
                                       device)
        tr.load_weights(self.trainer.net.params, self.weights)
        self.feed = Feed(files, cell, cfg, sub_seed(seed, "loader"), device)
        self.outs = []
        inner = self.trainer.train_batch

        def recorded(*a, **k):
            out = inner(*a, **k)
            self.outs.append((out.loss, out.num_logprob, out.den_logprob,
                              out.skipped))
            return out
        self.trainer.train_batch = recorded

    def first_steps(self) -> dict:
        t = self.trainer
        keys = tr.leaf_keys(self.weights)
        tap = tr.OutputTap(t.net)
        chain = tr.ChainTap(t.den)
        scale = (float(t.scale_state.scale)
                 if self.spec["cell"]["loss_scaling"] else 1.0)
        t.train_epoch(self.feed.take(1))
        grad1 = tr.leaf_norms(t.opt_state["velocity"], keys)
        grad1_vec = tr.host_leaves(t.opt_state["velocity"], keys)
        t.train_epoch(self.feed.take(tr.CHECK_STEPS - 1))
        params = t.net.params
        with torch.no_grad():
            change = dict(zip(keys, torch.stack(
                [(params[l][k] - self.weights[l][k]).norm()
                 for l, k in keys]).tolist()))
        delta = tr.param_deltas(params, self.weights, keys)
        vals = tr.as_list([x for o in self.outs for x in o])
        vals = [vals[i::4] for i in range(4)]
        t.train_epoch(self.feed.take(self.spec["cell"]["warmup_steps"]
                                     - tr.CHECK_STEPS))
        tr.sync(self.device)
        self.outs.clear()
        return {"loss": vals[0], "num_lp": vals[1], "den_lp": vals[2],
                "skipped": vals[3], "grad1": grad1, "change": change,
                "grad1_vec": grad1_vec, "delta": delta, "outs": tap.outs,
                "chain": chain.readings(scale, vals[1][0])}

    def reference_batches(self) -> list:
        """The first three batches as the ark files hold them, worked out
        again from the generator's examples by key."""
        by_key = {ex["key"]: ex for ex in self.examples}
        out = []
        for keys in self.feed.keys[:tr.CHECK_STEPS]:
            exs = [by_key[k] for k in keys]
            feats = torch.as_tensor(np.stack(
                [cm_round_trip(ex["features"]) for ex in exs]),
                device=self.device)
            ivecs = torch.as_tensor(np.stack(
                [cm2_round_trip(ex["ivector"])[0] for ex in exs]),
                device=self.device)
            B, n = len(exs), len(exs[0]["pdfs"])
            out.append({"features": feats, "ivectors": ivecs,
                        "weights": torch.ones(B, device=self.device),
                        "deriv_weights": torch.ones((B, n),
                                                    device=self.device),
                        "num": numerator_arrays(exs, 0, 0,
                                                self.spec["config"]["pdfs"]),
                        "left_context": exs[0]["left"]})
        return out

    def reference_inputs(self) -> tuple:
        """(weights, batches, learning rates, SpecAugment seed) of the
        steps the reference follows."""
        return (self.weights, self.reference_batches(),
                [recipe_lr(i, self.spec["cell"])
                 for i in range(tr.CHECK_STEPS)], self.trainer_seed)

    def close(self) -> None:
        self.feed.close()


def run(spec: dict, args, device, t_start: float) -> dict:
    cell = spec["cell"]
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False   # as tools.train
    workdir = tempfile.mkdtemp(prefix="bench_egs_")
    try:
        return _run(spec, args, device, t_start, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(spec, args, device, t_start, workdir) -> dict:
    cell = spec["cell"]
    shared = prepare(spec, device)
    r = Run(shared, spec, args.seed, device, workdir)
    prog = r.first_steps()
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    try:
        return _window(spec, args, device, r, shared, prog, setup_s)
    finally:
        r.close()


def _window(spec, args, device, r, shared, prog, setup_s) -> dict:
    cell = spec["cell"]
    feed, trainer = r.feed, r.trainer
    tracer = Tracer(device) if args.trace else None
    if tracer:
        tracer.warm_up()
    start_pull = feed.pulls
    host = tr.HostLog()
    feed.on_pull = lambda i: host.mark() if i > start_pull else None
    feed.record = True
    g0 = trainer.global_step
    tr.sync(device)
    t0 = time.perf_counter()
    host.start(t0)
    deadline = t0 + args.seconds
    trainer.train_epoch(feed.until(deadline))
    tr.sync(device)
    t1 = time.perf_counter()
    host.stop()
    feed.on_pull, feed.record = None, False
    n = trainer.global_step - g0
    # step j of the window ran between the events of pulls j + 1 and j + 2
    ev = feed.events
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, len(ev) - 1)]
    period = cell["ng_update_period"]
    ng_due = [(g0 + i - 1) % period == 0 for i in range(1, len(ev) - 1)]
    if tracer:
        # the traced span follows the window, so that the window runs as an
        # untraced run's does: the profiler slows the host's side of a step
        tracer.start()
        trainer.train_epoch(feed.take(cell["trace_steps"]))
        tracer.stop()
    vals = tr.as_list([x for o in r.outs for x in (o[0], o[3])])
    failed = sum(1 for l, s in zip(vals[0::2], vals[1::2])
                 if s != 0 or not tr.finite([l])[0])
    rec = {"setup_s": setup_s, "window_s": t1 - t0, "steps": n,
           "audio_s": n * cell["batch"] * cell["frames_out"]
           * spec["config"]["frame_subsampling_factor"] / 100.0,
           "attempted": len(r.outs), "failed": failed,
           "memory_peak_bytes": tr.memory_peak(device),
           "flops_per_step": tr.flops_per_step(spec, cell["frames_in"],
                                               cell["natural_gradient"]),
           "traced_steps": cell["trace_steps"] if tracer else 0,
           "host": host.summary(), "loader_wait_s": list(feed.waits),
           "step_ms": step_ms, "ng_due": ng_due if cell["natural_gradient"]
           else None,
           "den_scan_bound": tr.den_scan_bound(spec), "trace": None}
    if tracer:
        rec["trace"] = tracer.summary()
    from benchmark.harness.core import power_limit
    rec["power_limit"] = power_limit() if device.type == "cuda" else None

    weights, batches, lrs, mask_seed = r.reference_inputs()
    r.close()
    r.trainer = r.outs = None
    del shared, trainer, feed
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
