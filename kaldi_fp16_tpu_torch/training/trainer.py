"""Trainer: the loop around the train step, on PyTorch.

Port of kaldi_fp16_tpu/training/trainer.py (`exponential_lr` :31,
`TrainerMetrics` :43, `Trainer` :58-323): exponential LR decay, metric
aggregation, eval passes and checkpoint restore over ChainBatches from
io/dataloader.py, on one device per rank (default: the current CUDA
device).

On a card the loop overlaps uploads with compute: `place_batch` copies a
batch from pinned host buffers with non_blocking copies on a side
stream, so `train_epoch` uploads batch i+1 while step i runs; the step
makes the default stream wait for the side stream (`wait_stream`), and
every uploaded tensor is marked as used on the default stream
(`record_stream`), so the allocator cannot hand its memory to the next
upload while the step still reads it.  Per-step metrics stay on the
device and are drained in one transfer when `metrics` is read.  The step
itself reads the device once (skip / orthonormal / NG counters,
training/train_step.py).

The SpecAugment masks come from `self.generator`, a torch.Generator on
the device seeded with `seed`; its state is what a checkpoint records
(`rng_state`), so a resumed run replays the killed one.  On a card that
also needs cudnn.deterministic (the direct conv's weight gradient may
otherwise take a nondeterministic algorithm), which the caller sets:
tools/train.py does so around its run.

Data parallel (`group`, a DataGroup of parallel/mesh.py; the JAX
Trainer's `mesh`, trainer.py:67-140 there): the state starts as rank 0's
(broadcast), each batch is the global batch and `place_batch` uploads
only this rank's rows (shard_batches=False: each rank's batches are its
own, e.g. read from its file shard), and the steps' outputs, the metrics
and the eval pass are the global batch's.  On a mesh with seq and model
axes (the JAX Trainer's `place_states`, :117-140 there) the network and
the SGD velocities then hold this rank's columns of the sharded layers,
and `place_batch` uploads this rank's rows and frames.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.io.batch import ChainBatch
from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    broadcast_train_state, shard_chain_batch, shard_train_state,
)
from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes
from kaldi_fp16_tpu_torch.training.train_step import (
    EvalStepOutput, TrainConfig, TrainStepOutput, init_train_state,
    make_eval_step, make_train_step,
)

_GRAPH_FIELDS = ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask",
                 "start", "final_logw")


def upload_batch(batch: ChainBatch, device: torch.device,
                 copy_stream=None):
    """Copy a batch's arrays and numerator graph to `device`: on a card
    from pinned host buffers with non_blocking copies on `copy_stream`.
    Returns (arrays, num_graph) of device tensors; `wait_upload` makes
    the current stream wait for them."""
    host = dict(batch.arrays())
    if batch.deriv_weights is not None:
        host["deriv_weights"] = batch.deriv_weights
    g = batch.num_graph
    for name in _GRAPH_FIELDS:
        host["graph/" + name] = getattr(g, name)
    host = {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in host.items()}
    if copy_stream is not None:
        with torch.cuda.stream(copy_stream):
            placed = {k: v.pin_memory().to(device, non_blocking=True)
                      for k, v in host.items()}
    else:
        placed = {k: v.to(device) for k, v in host.items()}
    graph = NumeratorGraphBatch(
        **{name: placed.pop("graph/" + name) for name in _GRAPH_FIELDS},
        num_states=g.num_states, num_arcs=g.num_arcs)
    return placed, graph


def wait_upload(placed, device: torch.device, copy_stream=None) -> None:
    """Make the current stream wait for the uploads of `placed` on
    `copy_stream` and mark its tensors as used there."""
    if copy_stream is None:
        return
    main = torch.cuda.current_stream(device)
    main.wait_stream(copy_stream)
    arrays, graph = placed
    for t in list(arrays.values()) + [getattr(graph, n)
                                      for n in _GRAPH_FIELDS]:
        t.record_stream(main)


def exponential_lr(initial: float, final: float, num_steps: int
                   ) -> Callable[[int], float]:
    """Kaldi-style exponential decay lr(t) = li * (lf/li)^(t/T)."""
    ratio = final / initial

    def lr(step: int) -> float:
        frac = min(step / max(num_steps, 1), 1.0)
        return initial * (ratio ** frac)
    return lr


@dataclass
class TrainerMetrics:
    steps: int = 0
    examples: int = 0
    total_objf: float = 0.0
    total_weight: float = 0.0
    total_xent: float = 0.0
    skipped_steps: int = 0
    step_seconds: float = 0.0
    history: List[Dict] = field(default_factory=list)

    @property
    def objf_per_frame(self) -> float:
        return self.total_objf / max(self.total_weight, 1e-9)


class Trainer:
    """Drives train and eval steps over ChainBatches on one device (per
    rank of `group`)."""

    def __init__(self, model: Model, den: DenominatorComputation,
                 config: TrainConfig = TrainConfig(),
                 chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 seed: int = 0, device=None, group=None,
                 shard_batches: bool = True):
        self.device = resolve_device(device)
        self.group = group
        self.shard_batches = shard_batches
        self._cuda = self.device.type == "cuda"
        self.model = model
        self.den = den
        self.config = config
        self.chain_opts = chain_opts
        self.lr_schedule = lr_schedule
        self._metrics = TrainerMetrics()
        self._pending: List = []   # queued (device scalars, w_frames) rows
        self._steps: Dict = {}
        # the weights come from a CPU generator, so a run on the card and
        # one on the CPU start from the same parameters
        self.net, self.opt_state, self.scale_state = init_train_state(
            model, torch.Generator().manual_seed(seed), config, self.device)
        if group is not None:
            broadcast_train_state(self.net, self.opt_state, self.scale_state,
                                  group)
            self.opt_state = shard_train_state(self.net, self.opt_state,
                                               group)
        data = mesh_axes(group).data
        self._data_world = data.world if data is not None else 1
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.global_step = 0
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)

    @property
    def rng_state(self) -> torch.Tensor:
        """The SpecAugment generator's state: pass it as
        DataPosition.rng_state when checkpointing."""
        return self.generator.get_state()

    def restore(self, mgr, step=None):
        """Restore the network, optimizer and loss-scale states, the global
        step and the generator's state from a CheckpointManager.  Returns
        the DataPosition."""
        self.opt_state, self.scale_state, gstep, pos = mgr.restore(
            step, self.net, self.opt_state, self.scale_state)
        self.global_step = gstep
        if pos.rng_state is not None:
            self.generator.set_state(pos.rng_state)
        return pos

    def _validate_geometry(self, batch: ChainBatch) -> None:
        # a left_context outside the features would misalign supervision
        # frames with labels; check on the host before any upload
        stride = self.config.frame_subsampling_factor
        T_in = batch.features.shape[1]
        need = int(batch.left_context) + (batch.frames_per_seq - 1) * stride + 1
        if batch.left_context < 0 or need > T_in:
            raise ValueError(
                f"bad bucket geometry: left_context={batch.left_context} + "
                f"(n_out={batch.frames_per_seq}-1)*stride={stride}+1 needs "
                f"{need} input frames but features have T_in={T_in}")
        if (self.group is not None and self.shard_batches
                and batch.batch_size % self._data_world):
            raise ValueError(
                f"batch {batch.batch_size} not divisible by the data "
                f"group's {self._data_world} ranks (drop the remainder)")

    def place_batch(self, batch: ChainBatch):
        """Upload a batch's arrays and numerator graph to the device
        without running a step, so a loop can upload batch i+1 while step
        i runs.  Returns (arrays, num_graph) of device tensors; under a
        data group, of this rank's rows."""
        self._validate_geometry(batch)
        if self.group is not None and self.shard_batches:
            batch = shard_chain_batch(batch, self.group)
        return upload_batch(batch, self.device, self._copy_stream)

    def _step_fn(self, batch: ChainBatch):
        """One step per supervision length (the step's num_frames_out)."""
        key = ("train", batch.frames_per_seq)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self.net, self.den, None, self.chain_opts,
                self.config, num_frames_out=batch.frames_per_seq,
                group=self.group)
        return self._steps[key]

    def train_batch(self, batch: ChainBatch, placed=None) -> TrainStepOutput:
        """Run one train step.  `placed`: the batch pre-uploaded by
        place_batch.  Metrics queue as device scalars (see `metrics`)."""
        if placed is None:
            placed = self.place_batch(batch)
        else:
            self._validate_geometry(batch)
        wait_upload(placed, self.device, self._copy_stream)
        arrays, graph = placed
        step = self._step_fn(batch)
        lr = (self.lr_schedule(self.global_step) if self.lr_schedule
              else self.config.learning_rate)
        t0 = time.perf_counter()
        self.opt_state, self.scale_state, out = step(
            self.opt_state, self.scale_state, arrays,
            generator=self.generator, lr=lr, num_graph=graph,
            left_context=batch.left_context)
        dt = time.perf_counter() - t0

        self.global_step += 1
        m = self._metrics
        m.steps += 1
        m.examples += batch.batch_size * (
            self._data_world if not self.shard_batches else 1)
        # chain objective only (out.loss also folds in the xent term);
        # the global batch's weighted frames
        self._pending.append(
            (out.objf_per_frame, out.xent_objf, out.skipped,
             out.weight_frames))
        m.step_seconds += dt
        return out

    def _flush_pending(self) -> None:
        """Drain the queued per-step device scalars into the host metrics
        in one transfer."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        vals = torch.stack([torch.stack([x.float() for x in p])
                            for p in pending]).tolist()
        m = self._metrics
        for objf_pf, xent, skipped, w_frames in vals:
            m.total_objf += objf_pf * w_frames
            m.total_weight += w_frames
            m.total_xent += xent
            m.skipped_steps += int(skipped != 0)

    @property
    def metrics(self) -> TrainerMetrics:
        self._flush_pending()
        return self._metrics

    def eval_batch(self, batch: ChainBatch) -> EvalStepOutput:
        """Held-out diagnostic on one batch (compute_prob analog):
        eval-mode forward + chain objf, no update.  Device scalars."""
        self._validate_geometry(batch)
        key = ("eval", batch.frames_per_seq)
        if key not in self._steps:
            self._steps[key] = make_eval_step(
                self.model, self.net, self.den, self.chain_opts, self.config,
                num_frames_out=batch.frames_per_seq, group=self.group)
        placed = self.place_batch(batch)
        wait_upload(placed, self.device, self._copy_stream)
        arrays, graph = placed
        return self._steps[key](arrays, graph, batch.left_context)

    def eval_epoch(self, batches):
        """Weighted objf/frame, num, den and xent over a held-out set (one
        pass), drained in one transfer: dict(objf_per_frame, num_logprob,
        den_logprob, xent_objf, frames, batches), or None without batches
        or weight."""
        outs = [self.eval_batch(b) for b in batches]
        if not outs:
            return None
        vals = torch.stack([torch.stack([o.objf_per_frame, o.num_logprob,
                                         o.den_logprob, o.xent_objf,
                                         o.weight_frames])
                            for o in outs]).tolist()
        tot_w = sum(v[4] for v in vals)
        if tot_w == 0:
            return None
        return {
            "objf_per_frame": sum(v[0] * v[4] for v in vals) / tot_w,
            "num_logprob": sum(v[1] * v[4] for v in vals) / tot_w,
            "den_logprob": sum(v[2] * v[4] for v in vals) / tot_w,
            "xent_objf": float(np.sum([v[3] for v in vals])),
            "frames": tot_w,
            "batches": len(vals),
        }

    def train_epoch(self, batches, log_every: int = 0,
                    log_fn=print) -> TrainerMetrics:
        """Pipelined epoch loop: batch i+1 is uploaded while step i runs;
        the host reads step outputs only on the log cadence."""
        it = iter(batches)
        nxt = next(it, None)
        placed = self.place_batch(nxt) if nxt is not None else None
        i = 0
        while nxt is not None:
            batch, cur = nxt, placed
            nxt = next(it, None)
            out = self.train_batch(batch, placed=cur)
            placed = self.place_batch(nxt) if nxt is not None else None
            i += 1
            if log_every and i % log_every == 0:
                log_fn(f"step {self.global_step}: loss={float(out.loss):.4f} "
                       f"objf/frame={float(out.objf_per_frame):.4f} "
                       f"num={float(out.num_logprob):.4f} "
                       f"den={float(out.den_logprob):.4f} "
                       f"|dW|={float(out.param_change_norm):.4f}")
        return self.metrics
