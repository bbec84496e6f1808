"""The chain training and eval steps on PyTorch.

Port of kaldi_fp16_tpu/training/train_step.py (`TrainConfig` :51,
`apply_natural_gradient` :97-138, `make_train_step` :141-364,
`init_train_state` :367, `EvalStepOutput` / `make_eval_step` :385-490).
Per step, as Kaldi NnetChainTrainer::TrainInternal:

  features/ivectors -> Network.forward (bf16 compute, frame grid)
  -> supervision frames (stride 3 from left_context)
  -> chain objective (autograd.Function: analytic forward-backward deriv)
  [+ xent head: xent_regularize * sum(num_post * log_softmax)]
  -> backward -> loss-scale bookkeeping
  [-> NG-SGD: update the sites' Fisher factors, precondition the grads]
  -> SGD with momentum, per-component + global max-change
  -> every `orthonormal_interval` non-skipped steps, the semi-orthogonal
     constraint on the bottleneck linears.

The step updates the Network's parameters and BN statistics in place.  A
non-finite gradient (judged on the raw grads) skips the update, keeps the
old BN statistics and leaves the NG states as they were (their counters
do not advance).  The numerator graph is either fixed when the step is
made or passed with each call, with that batch's left_context (the
Trainer's path: the JAX package's `graph_in_args`).

`remat` (the JAX package's jax.checkpoint of the forward, train_step.py
:242 there) runs the network forward under torch.utils.checkpoint: its
activations are recomputed in the backward instead of kept, which changes
memory and never the numbers.  The forward has side effects that JAX's
pure function has not, and the recompute must not repeat them: the
SpecAugment masks are drawn before the checkpointed region (the
generator then ends where a plain step leaves it), the NG sites are
frozen once the first forward has recorded them, and BatchNorm's running
statistics are those the first forward returned (the forward never writes
them; the recompute's are discarded).  Under a data group the recompute
repeats BatchNorm's all-reduces, on every rank alike.

The host learns each flag when it is needed, never sooner.  A call's
`skip` goes to the host in a non-blocking copy (a pinned slot and a CUDA
event; on the CPU it is there already), which the next call waits on and
folds into a host count of the non-skipped steps, the mirror of
opt_state["step"]: by then the card has finished the previous backward
and holds this call's forward and backward in its queue, so the host
stays one step ahead and never drains it.  Whether the orthonormal
constraint falls on a call comes from that count, exact once every
earlier call's skip is in; the call's own skip is applied on the device
(the constraint is selected away on a skipped step, as the update is).
Only NG's host branch needs the call's own skip and the sites' update
counters, so a step with NG sites reads them after the backward, in one
transfer.  The count is seeded by one read of opt_state["step"] on the
first call and whenever a call is given a "step" tensor that the step
did not return last (a resume, a swapped state).  `step.blocking_reads`
counts the calls that waited on their own device values: without NG only
the seeding ones, with NG every call.  NG's eigensolves run only on the
steps where a counter is due (every 4th), batched over the sites of one
shape (training/natural_gradient.py).

Host spans (utils/spans.py) tile the step's body in code order:
`train_step.forward` (inputs, frame geometry, the network forward, the
chain head's frames), the objective (its `chain.den` and
`chain.numerator`, chain/objective.py), `train_step.backward` (xent,
backward, grads, unscale, all-reduce, finiteness, loss scale),
`train_step.read` (the wait for the previous call's skip; this call's
own read with NG or on a re-seed), `ng.fisher_update` (only on the steps
that fold in statistics), `ng.precondition` and `train_step.update`, all
inside `train_step`.

A call that needs no device value on the host replays the step as one
CUDA graph (`graph_eligible`: CUDA tensors, no NG sites, no group, no
remat, no loss scaling, the config's own rate, no given SpecAugment
masks, no generator off the card).  The first call of a geometry runs
eagerly (it loads the kernels, cuBLAS handles and shared-memory
attributes); the second captures the step, forward to the committed
update, and replays it; later calls copy their inputs into the graph's
static buffers and replay.  The geometry is the batch's shapes and
dtypes, the numerator graph's shapes, left_context, the generator, the
BatchNorm switch and the matmul and cuDNN settings; every graph of a
step draws from one memory pool.  opt_state lives in static storage that
the graph updates in place: the returned opt_state holds it, and a call
given any other tensors (a resume, a swapped state) copies them in first.
The host count of non-skipped steps is kept as on the eager path; the
orthonormal constraint, due on the host's count, is a small graph of its
own replayed after the step (its first due call runs it eagerly and
captures it).  A generator on the card is registered with each graph, so
a replay draws the SpecAugment masks an eager call would.  A replay adds
to the kernels' launch counts what its captured call added
(`_LAUNCH_COUNTERS`).  On a replayed call only `train_step`,
`train_step.replay` (the copy-in and the replay) and `train_step.read`
open; `step.graph_captures` and `step.graph_replays` count.  Every other
call runs the eager step; `_GRAPHS = False` forces it.

Data parallel (`group`, a DataGroup of parallel/mesh.py): the batch is
this rank's rows of the global batch, and each global reduction of the
JAX package's sharded step is a collective here (parallel/
data_parallel.py): BatchNorm's statistics, the SpecAugment masks drawn
for the global batch, the gradients (one all-reduce with the reported
sums and the non-finite count, before the finiteness check and NG), and
NG's sample statistics.  The objective is a plain sum over sequences, so
the summed gradient is the full batch's; every rank then holds the same
bits and takes the same update, skip and loss scale.  group=None is the
single-process step.

On a mesh with seq and model axes (a parallel.mesh.Mesh) the batch is
this rank's rows and frames, and the network its columns of the sharded
layers.  The forward returns the outputs gathered over both axes, so
every seq and model rank computes the loss of its rows whole; a seq
rank's gradients are its frames' part, summed over data x seq with the
data axis's, and the reported sums count the first seq rank's only.
Over the model axis nothing is summed but what the sharded leaves add
to the whole: the non-finite count, the norms of max-change and
grad_norm (training/optimizer.py).  NG-SGD gathers a column-sharded
site's output derivatives and its gradient over the model axis, and
preconditions them whole, with states replicated on every rank.  Once a
step, model rank 0's replicated values (the replicated leaves'
gradients, BatchNorm's statistics, the NG states it updated, the
reported sums) are broadcast over the model axis, so the ranks hold one
replica whatever their kernels round (data_parallel.one_replica).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch
from kaldi_fp16_tpu_torch.chain.numerator import numerator_forward_backward
from kaldi_fp16_tpu_torch.chain.objective import (
    ChainTrainingOpts, make_chain_objf_with_post,
)
from kaldi_fp16_tpu_torch.device import resolve_device
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.ops.den_scan import fused_backward, fused_forward
from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
from kaldi_fp16_tpu_torch.ops.numerator import INDEX_FIELDS
from kaldi_fp16_tpu_torch.ops.segment_reduce import (
    segment_order, segment_reduce,
)
from kaldi_fp16_tpu_torch.models import network as network_module
from kaldi_fp16_tpu_torch.models.model import Model
from kaldi_fp16_tpu_torch.models.network import (
    ChunkTimes, NGContext, Network, conv_weight_from_oihw, conv_weight_to_oihw,
    draw_spec_masks, grid_layers, ng_sites, trainable_mask,
)
from kaldi_fp16_tpu_torch.models.xconfig import LayerType
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    COLS, TimeChunks, all_reduce_grads, all_reduce_sum, gather_over,
    model_slice, one_replica, param_shardings, sharded_dim,
)
from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes
from kaldi_fp16_tpu_torch.training.loss_scale import (
    grads_finite, init_loss_scale, tree_leaves, tree_map, unscale_grads,
    update_loss_scale,
)
from kaldi_fp16_tpu_torch.training.natural_gradient import (
    NGConfig, advance, fisher_update, init_ng_state, precondition_grad,
    update_due,
)
from kaldi_fp16_tpu_torch.training.optimizer import (
    SGDConfig, init_sgd_state, layer_hyperparams, sgd_update,
)
from kaldi_fp16_tpu_torch.training.orthonormal import (
    constrain_orthonormal, orthonormal_targets,
)
from kaldi_fp16_tpu_torch.utils.spans import span


@dataclass(frozen=True)
class TrainConfig:
    """(ref: TrainConfig train_step.go:21-28 + ChainTrainingOpts)."""
    learning_rate: float = 1e-3
    momentum: float = 0.0
    max_param_change: float = 2.0
    frame_subsampling_factor: int = 3
    left_context: int = 0          # row offset of the first supervised frame
    xent_regularize: float = 0.0
    use_loss_scaling: bool = False
    compute_dtype: str = "bfloat16"
    # Kaldi NG-SGD: precondition every affine gradient with online low-rank
    # Fisher estimates of the matmul inputs / output derivatives
    natural_gradient: bool = False
    ng_rank_in: int = 20
    ng_rank_out: int = 80
    # semi-orthogonal constraint every N non-skipped steps (0 disables)
    orthonormal_interval: int = 4
    # run grid-eligible layers only at the supervision frame rate
    grid_subsample: bool = True
    # rematerialize the network forward in the backward pass
    # (torch.utils.checkpoint): trades FLOPs for activation memory
    remat: bool = False
    # Kaldi's --trainer.deriv-truncate-margin: every derivative at input
    # frames more than this many frames (plus the model's context) outside
    # the supervised span is zero (None: no window)
    deriv_truncate_margin: Optional[int] = None


class TrainStepOutput(NamedTuple):
    loss: torch.Tensor
    objf_per_frame: torch.Tensor
    num_logprob: torch.Tensor
    den_logprob: torch.Tensor
    xent_objf: torch.Tensor
    param_change_norm: torch.Tensor
    grad_norm: torch.Tensor
    loss_scale: torch.Tensor
    skipped: torch.Tensor
    ok: torch.Tensor
    weight_frames: torch.Tensor   # sum of weights * supervision frames


def _compute_dtype(config: TrainConfig):
    return (torch.bfloat16 if config.compute_dtype == "bfloat16"
            else torch.float32)


def _frame_geometry(model: Model, config: TrainConfig, T_in: int,
                    n_out: int, left_context: int):
    """(grid layer set, time_subsample for the forward, pick_frames) of
    one batch geometry, as the JAX step's (train_step.py:201-228)."""
    stride = config.frame_subsampling_factor
    grid = (grid_layers(model, stride) if config.grid_subsample
            else frozenset())
    use_grid = model.chain_output().name in grid
    n_grid = (T_in - stride) // stride + 1 if use_grid else 0
    if use_grid and n_out > n_grid:
        # chunk shorter than the supervision span: full-rate program
        use_grid, grid, n_grid = False, frozenset(), 0
    time_subsample = ((stride, left_context % stride, n_grid)
                      if use_grid else None)

    def pick_frames(full, on_grid):
        if on_grid:
            s = left_context // stride
            return full[:, s:s + n_out]
        return full[:, left_context:
                    left_context + (n_out - 1) * stride + 1:stride]

    return grid, time_subsample, pick_frames


def chunk_times(model: Model, config: TrainConfig, n_out: int,
                left_context: int) -> ChunkTimes:
    """The chunk's origin (its first supervised frame) and, under a
    deriv-truncate-margin, the derivative window: the supervised span
    widened by the margin and the model's context (steps/nnet3/chain/
    train.py's min-deriv-time and max-deriv-time-relative)."""
    margin = config.deriv_truncate_margin
    if margin is None:
        return ChunkTimes(left_context)
    left, right = model.time_context()
    last = left_context + (n_out - 1) * config.frame_subsampling_factor
    return ChunkTimes(left_context, left_context - margin - left,
                      last + margin + right)


def _batch_inputs(batch, config: TrainConfig, num_frames_out, group=None):
    """(features, ivectors, weights, deriv_weights, n_out, T_in): under a
    seq axis the features are this rank's frames, T_in the sequence's,
    and the deriv_weights are gathered whole (the loss runs on every
    frame)."""
    feats = batch["features"]
    B, T_in, _ = feats.shape
    seq = mesh_axes(group).seq
    if seq is not None:
        T_in *= seq.world
    dev = feats.device
    stride = config.frame_subsampling_factor
    n_out = num_frames_out or (T_in - config.left_context + stride - 1) // stride
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones(B, dtype=torch.float32, device=dev)
    dws = batch.get("deriv_weights")
    if dws is None:
        dws = torch.ones((B, n_out), dtype=torch.float32, device=dev)
    else:
        dws = dws.float()
        if seq is not None:
            with torch.no_grad():
                dws = TimeChunks.even(dws.shape[1], group).gather(dws)
    return feats, batch.get("ivectors"), weights, dws, n_out, T_in


def _reported(stats, group):
    """The sums every rank reports for its rows, counted once over the
    seq axis (its ranks hold the same rows and computed the same sums)."""
    seq = mesh_axes(group).seq
    if seq is None or seq.rank == 0:
        return stats
    return [torch.zeros_like(t) for t in stats]


def _site_samples(site, x: torch.Tensor, dtype) -> torch.Tensor:
    """A site's input sample matrix [N, D(+1)] in `dtype` (the NG states'
    dtype: fp32 in training): the bias column of ones when the site has a
    bias (train_step.py:112-118)."""
    x2 = x.to(dtype).reshape(-1, x.shape[-1])
    if site["b"] is not None:
        x2 = torch.cat([x2, torch.ones((x2.shape[0], 1), dtype=dtype,
                                       device=x2.device)], 1)
    return x2


def _site_derivs(site, xs, gs, dtype) -> torch.Tensor:
    """A site's output-derivative sample matrix [N, out_dim]: zeros where
    the site has no path to the loss (the xent head at xent_regularize
    0), as the gradient of the JAX package's zero tap is there."""
    g = gs.get(site["name"])
    if g is None:
        x = xs[site["name"]]
        return torch.zeros((x[..., 0].numel(), site["out_dim"]),
                           dtype=dtype, device=x.device)
    return g.to(dtype).reshape(-1, g.shape[-1])


def update_ng_states(sites, ng_states, xs, gs, counters, cfg_in: NGConfig,
                     cfg_out: NGConfig, group=None, counts=None,
                     model_group=None, col_sites=frozenset()):
    """One NG update call of every site's two states from this batch's
    inputs xs and output derivatives gs.  counters[(site, side)] is the
    state's counter read on the host: due states fold in their samples,
    batched per state shape; the others only advance their counter.
    Under a data group the samples are this rank's, the statistics every
    rank's (fisher_update; counts: {site: every rank's samples}).  The
    sites in col_sites hold their output columns over model_group: their
    output derivatives are gathered whole first (one all-reduce)."""
    new = {nm: dict(st) for nm, st in ng_states.items()}
    counts = counts or {}
    groups: Dict[tuple, list] = {}
    gather = []
    for site in sites:
        nm = site["name"]
        for side, cfg in (("in", cfg_in), ("out", cfg_out)):
            st = ng_states[nm][side]
            if update_due(counters[nm, side], cfg):
                groups.setdefault((tuple(st.v.shape), cfg), []).append(
                    (site, side))
                if side == "out" and nm in col_sites and nm in gs:
                    gather.append(nm)
            else:
                new[nm][side] = advance(st)
    if not groups:
        return new
    with span("ng.fisher_update"):
        if model_group is not None and gather:
            gs = dict(gs)
            gs.update(zip(gather, gather_over([gs[nm] for nm in gather],
                                              [-1] * len(gather),
                                              model_group)))
        for (_, cfg), members in groups.items():
            # one group's sample matrices at a time (a patch-lowered conv's
            # are ~1-2 GB at flagship width)
            states = [ng_states[site["name"]][side] for site, side in members]
            dtype = states[0].v.dtype
            samples = [_site_samples(site, xs[site["name"]], dtype)
                       if side == "in" else _site_derivs(site, xs, gs, dtype)
                       for site, side in members]
            for (site, side), st in zip(
                    members, fisher_update(states, samples, cfg, group,
                                           [counts.get(site["name"])
                                            for site, _ in members])):
                new[site["name"]][side] = st
            del samples
    return new


def apply_natural_gradient(model: Model, sites, ng_states, grads,
                           cfg_in: NGConfig, specs=None, model_group=None):
    """Precondition each site's accumulated gradient on both sides,
    dW_ext <- gamma * P_in^-1 [dW; db] P_out^-1 (train_step.py:126-137).
    Conv weights are taken to the JAX layout [k * nf_in, nf_out] and back.
    The preconditioned grads come out in the NG states' dtype (fp32 in
    training).  Under a model axis (specs: param_shardings) a sharded
    site's gradient is gathered whole (one all-reduce for every site),
    preconditioned, and cut back to this rank's slice.  Returns new grads
    (the input dicts are not modified)."""
    grads = {k: dict(v) for k, v in grads.items()}
    keys = []
    if model_group is not None:
        keys = [(site["layer"], site[k]) for site in sites for k in ("w", "b")
                if site[k] is not None and
                sharded_dim(specs[site["layer"]][site[k]]) is not None]
    whole = dict(zip(keys, gather_over(
        [grads[l][k] for l, k in keys],
        [sharded_dim(specs[l][k]) for l, k in keys], model_group)))

    def put(lname, pname, t):
        if (lname, pname) in whole:
            t = model_slice(t, sharded_dim(specs[lname][pname]),
                            model_group.rank, model_group.world,
                            f"{lname}/{pname}")
        grads[lname][pname] = t

    for site in sites:
        lname = site["layer"]
        layer = model.layer_map[lname]
        conv = layer.type == LayerType.CONV_RELU_BATCHNORM
        g = grads[lname]
        st = ng_states[site["name"]]
        dtype = st["in"].v.dtype
        dw = whole.get((lname, site["w"]), g[site["w"]]).to(dtype)
        if conv:
            dw = conv_weight_from_oihw(dw, layer.spec)
        if site["b"] is not None:
            db = whole.get((lname, site["b"]), g[site["b"]])
            dw = torch.cat([dw, db.to(dtype)[None, :]], dim=0)
        dwe = precondition_grad(st["in"], st["out"], dw, cfg_in)
        if site["b"] is not None:
            put(lname, site["b"], dwe[-1])
            dwe = dwe[:-1]
        put(lname, site["w"],
            conv_weight_to_oihw(dwe, layer.spec) if conv else dwe)
    return grads


class _StepCount:
    """The host's count of non-skipped steps, one call late: the mirror of
    opt_state["step"] (see the module docstring)."""

    def __init__(self):
        self.done = None        # non-skipped steps before the last call's
        self.pending = None     # the last call's skip: (host value, event)
        self.returned = None    # the "step" tensor the last call returned
        self.slots = None       # two pinned host slots, used in turn
        self.turn = 0
        self.blocking_reads = 0  # calls that waited on their own values

    def seed(self, step: torch.Tensor) -> bool:
        """Read `step` on the device where it is not the tensor the last
        call returned, or nothing was counted yet; the last call's skip
        is then dropped.  Returns whether it read."""
        seeded = self.done is None or step is not self.returned
        self.returned = None
        if seeded:
            self.done, self.pending = int(step), None
        return seeded

    def fold(self, skip: torch.Tensor) -> int:
        """Send this call's skip to the host without a wait, then fold in
        the last call's, waiting on its copy.  Returns the non-skipped
        steps before this call."""
        pending, self.pending = self.pending, self._send(skip)
        if pending is not None:
            value, event = pending
            if event is not None:
                event.synchronize()
            self.done += 0 if bool(value) else 1
        return self.done

    def _send(self, skip: torch.Tensor):
        if skip.device.type != "cuda":
            return skip, None
        if self.slots is None:
            self.slots = [torch.empty((), dtype=torch.bool, pin_memory=True)
                          for _ in range(2)]
        slot = self.slots[self.turn]
        self.turn ^= 1
        slot.copy_(skip, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(skip.device))
        return slot, event


# False: every call runs the eager step (the tests' switch)
_GRAPHS = True

# the kernels' launch counts, (holder, attribute): a replay adds what its
# captured call added
_LAUNCH_COUNTERS = (
    (lstmp_recurrence, "launches"), (lstmp_recurrence, "reverse_launches"),
    (numerator_forward_backward, "launches"),
    (fused_forward, "launches"), (fused_forward, "launches_plane"),
    (fused_backward, "launches"), (fused_backward, "launches_plane"),
    (DenMatmul, "launches"), (DenMatmul, "launches_pre"),
    (segment_reduce, "launches"), (segment_order, "launches"))

BATCH_KEYS = ("features", "ivectors", "weights", "deriv_weights")
_NUM_FIELDS = ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask",
               "start", "final_logw")


def graph_eligible(device: torch.device, ng: bool, group, config: TrainConfig,
                   lr: Optional[float], spec_masks, generator,
                   batch_devices=()) -> bool:
    """Whether a call can replay the step as a CUDA graph: its tensors on
    a card, and nothing that reads a device value on the host (NG's
    counters), a collective (a group), a per-call rate (`lr`), a
    recompute (remat), loss scaling, masks given from outside, or a
    generator that is not the card's."""
    return (device.type == "cuda" and not ng and group is None
            and not config.remat and not config.use_loss_scaling
            and lr is None and spec_masks is None
            and all(d == device for d in batch_devices)
            and (generator is None
                 or (generator.device.type == "cuda"
                     and hasattr(torch.cuda.CUDAGraph,
                                 "register_generator_state"))))


def _copy_in(pairs) -> None:
    """dst.copy_(src) for each (dst, src): tensors on dst's device in one
    call; host arrays, for a card, through pinned memory, so that neither
    waits on the device."""
    near = [(d, s) for d, s in pairs if isinstance(s, torch.Tensor)
            and s.device == d.device and s is not d]
    if near:
        torch._foreach_copy_([d for d, _ in near], [s for _, s in near])
    for d, s in pairs:
        if not (isinstance(s, torch.Tensor) and s.device == d.device):
            src = torch.as_tensor(np.asarray(
                s.cpu() if isinstance(s, torch.Tensor) else s)).to(d.dtype)
            d.copy_(src.pin_memory() if d.is_cuda else src,
                    non_blocking=d.is_cuda)


class _Captured:
    """One geometry's graph: its static inputs and outputs."""

    def __init__(self, batch: dict, num: NumeratorGraphBatch, generator):
        self.batch = batch
        self.num = num
        self.generator = generator
        self.graph = None
        self.outs = None        # _pack's static output buffers
        self.launches = None    # [(holder, attribute, launches a call)]


class _StepGraphs:
    """The step's CUDA graphs (see the module docstring)."""

    def __init__(self):
        self.seen = {}          # geometry -> _Captured, or None: ran eagerly
        self.pool = None
        self.state = None       # static opt_state: {"velocity", "step"}
        self.keys = None        # [(layer, name)] of the velocity leaves
        self.skip = None        # the last replayed call's skip (static)
        self.constraint = None  # the orthonormal constraint's graph
        self.captures = self.replays = 0

    @staticmethod
    def key(batch: dict, num: NumeratorGraphBatch, left_context: int,
            generator) -> tuple:
        return (tuple((k, tuple(batch[k].shape), batch[k].dtype)
                      for k in BATCH_KEYS if batch.get(k) is not None),
                tuple(tuple(np.shape(getattr(num, f))) for f in _NUM_FIELDS),
                num.num_states, num.num_arcs, left_context,
                None if generator is None else id(generator),
                network_module._BN_LOWP_STATS,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark,
                torch.are_deterministic_algorithms_enabled(),
                torch.get_float32_matmul_precision())

    def load_state(self, opt_state: dict) -> None:
        """Copy a foreign opt_state into the static one (nothing where it
        is the static one)."""
        if self.state is None:
            vel = opt_state["velocity"]
            self.keys = [(l, k) for l, p in vel.items() for k in p]
            self.state = {"velocity": {l: {k: v.clone() for k, v in p.items()}
                                       for l, p in vel.items()},
                          "step": opt_state["step"].clone()}
        else:
            vel, mine = opt_state["velocity"], self.state["velocity"]
            _copy_in([(mine[l][k], vel[l][k]) for l, k in self.keys]
                     + [(self.state["step"], opt_state["step"])])

    def returned_state(self) -> dict:
        st = self.state
        return {"velocity": {l: dict(p) for l, p in st["velocity"].items()},
                "step": st["step"]}

    def static_inputs(self, batch: dict, num: NumeratorGraphBatch,
                      device, generator) -> _Captured:
        """A geometry's static input buffers, filled from this call."""
        sb = {k: batch[k].clone() for k in BATCH_KEYS
              if batch.get(k) is not None}
        fields = {f: torch.empty(np.shape(getattr(num, f)), device=device,
                                 dtype=torch.int32 if f in INDEX_FIELDS
                                 else torch.float32)
                  for f in _NUM_FIELDS}
        _copy_in([(fields[f], getattr(num, f)) for f in _NUM_FIELDS])
        static_num = dataclasses.replace(num, **fields)
        return _Captured(sb, static_num, generator)

    def fill(self, cap: _Captured, batch: dict,
             num: NumeratorGraphBatch) -> None:
        _copy_in([(cap.batch[k], batch[k]) for k in cap.batch]
                 + [(getattr(cap.num, f), getattr(num, f))
                    for f in _NUM_FIELDS])

    def capture(self, cap: _Captured, run) -> None:
        """Capture run(static state, static batch, static numerator
        graph) -> (new opt_state, outputs): its new opt_state is written
        into the static one, its skip into `skip`, its outputs into flat
        static buffers, one per dtype."""
        if self.pool is None:
            self.pool = _new_pool()
            self.skip = torch.zeros((), dtype=torch.bool,
                                    device=self.state["step"].device)
        graph = _new_graph()
        if cap.generator is not None:
            graph.register_generator_state(cap.generator)

        def body():
            new_opt, out = run(self.state, cap.batch, cap.num)
            torch._foreach_copy_(
                [self.state["velocity"][l][k] for l, k in self.keys]
                + [self.state["step"]],
                [new_opt["velocity"][l][k] for l, k in self.keys]
                + [new_opt["step"]])
            self.skip.copy_(out.skipped)
            return _pack(out)

        before = [getattr(h, a) for h, a in _LAUNCH_COUNTERS]
        cap.outs = _record(graph, self.pool, body)
        cap.launches = [(h, a, getattr(h, a) - b) for (h, a), b
                        in zip(_LAUNCH_COUNTERS, before) if getattr(h, a) != b]
        cap.graph = graph

    def replay(self, cap: _Captured, count: bool) -> dict:
        """Replay a geometry's graph; returns its outputs, copied out of
        the static buffers.  count: add its kernels' launches (the
        capturing call counted its own)."""
        cap.graph.replay()
        if count:
            for holder, attr, n in cap.launches:
                setattr(holder, attr, getattr(holder, attr) + n)
        outs = {}
        for flat, fields in cap.outs:
            vals = flat.clone()
            for name, offset, shape in fields:
                outs[name] = vals[offset:offset + int(np.prod(shape))
                                  ].view(shape)
        return outs

    def constrain(self, run) -> None:
        """run(skip): the orthonormal constraint on the step's parameters,
        selected away where `skip`.  Its first call runs it eagerly and
        captures it; later calls replay it."""
        if self.constraint is None:
            run(self.skip)
            graph = _new_graph()
            _record(graph, self.pool, lambda: run(self.skip))
            self.constraint = graph
        else:
            self.constraint.replay()


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _new_graph():
    return torch.cuda.CUDAGraph()


def _record(graph, pool, body):
    """Capture body() into `graph`, drawing from `pool`; returns what
    body returned (its tensors are the graph's static outputs)."""
    with torch.cuda.graph(graph, pool=pool):
        return body()


_OUTPUT_FIELDS = ("loss", "objf_per_frame", "num_logprob", "den_logprob",
                  "xent_objf", "param_change_norm", "grad_norm", "skipped",
                  "ok", "weight_frames")


def _pack(out: "TrainStepOutput") -> list:
    """The outputs that the graph computes, concatenated into one static
    buffer per dtype: [(buffer, [(field, offset, shape)])]."""
    groups: Dict[torch.dtype, list] = {}
    for name in _OUTPUT_FIELDS:
        t = getattr(out, name)
        groups.setdefault(t.dtype, []).append((name, t))
    packed = []
    for members in groups.values():
        fields, offset = [], 0
        for name, t in members:
            fields.append((name, offset, tuple(t.shape)))
            offset += t.numel()
        packed.append((torch.cat([t.detach().reshape(-1)
                                  for _, t in members]), fields))
    return packed


class _MadeStep:
    """A made train step: called as the step.  `blocking_reads` counts the
    calls that waited on their own device values, `graph_captures` and
    `graph_replays` the step's CUDA graphs.  The step's closures hold no
    reference back to it, so dropping it frees its graphs' memory pool."""

    def __init__(self, run, count: _StepCount, graphs: _StepGraphs):
        self._run, self._count, self._graphs = run, count, graphs

    def __call__(self, *args, **kwargs):
        return self._run(*args, **kwargs)

    @property
    def blocking_reads(self) -> int:
        return self._count.blocking_reads

    @property
    def graph_captures(self) -> int:
        return self._graphs.captures

    @property
    def graph_replays(self) -> int:
        return self._graphs.replays


def make_train_step(model: Model, net: Network,
                    den: DenominatorComputation,
                    num_graph: Optional[NumeratorGraphBatch] = None,
                    chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                    config: TrainConfig = TrainConfig(),
                    num_frames_out: Optional[int] = None, group=None):
    """Build step(opt_state, scale_state, batch, generator=None,
    spec_masks=None, lr=None, num_graph=None, left_context=None) ->
    (opt_state, scale_state, TrainStepOutput) for one batch geometry.

    batch: {"features" [B, T_in, D], "ivectors" [B, ivec] (if the model
    has them), "weights" [B] (optional), "deriv_weights" [B, n_out]
    (optional: masks the chain derivative and the xent head per frame)}.
    generator draws the SpecAugment masks (or spec_masks gives them).
    num_graph / left_context given to a call override the ones of the
    step (the numerator graph of that batch, its supervision offset).
    group: a DataGroup; batch and num_graph are then this rank's rows,
    and the outputs are the global batch's (see the module docstring).
    """
    hyper = layer_hyperparams(model)
    dtype = _compute_dtype(config)
    # two spellings of the Kaldi option exist; honour whichever is set
    xent_regularize = config.xent_regularize or chain_opts.xent_regularize
    sgd_cfg = SGDConfig(learning_rate=config.learning_rate,
                        momentum=config.momentum,
                        max_param_change=config.max_param_change)
    chain_head_name = model.chain_output().name
    xent_layer = model.xent_output()
    targets = (orthonormal_targets(model) if config.orthonormal_interval > 0
               else [])
    sites = ng_sites(model) if config.natural_gradient else []
    ng_cfg_in = NGConfig(rank=config.ng_rank_in)
    ng_cfg_out = NGConfig(rank=config.ng_rank_out)
    static_objf = (make_chain_objf_with_post(num_graph, den, chain_opts)
                   if num_graph is not None else None)
    ax = mesh_axes(group)
    specs = param_shardings(model, group, net.params)
    sharded = {l: {k: sharded_dim(spec) is not None for k, spec in p.items()}
               for l, p in specs.items()}
    col_sites = frozenset(s["name"] for s in sites
                          if specs[s["layer"]][s["w"]] == COLS)
    ng_keys = [(s["name"], side) for s in sites for side in ("in", "out")]
    interval = max(config.orthonormal_interval, 1)
    count = _StepCount()
    graphs = _StepGraphs()
    step_num_graph = num_graph

    def step(opt_state, scale_state, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             spec_masks: Optional[dict] = None, lr: Optional[float] = None,
             num_graph: Optional[NumeratorGraphBatch] = None,
             left_context: Optional[int] = None):
        with span("train_step"):
            num = step_num_graph if num_graph is None else num_graph
            feats = batch["features"]
            if (_GRAPHS and num is not None and graph_eligible(
                    feats.device, bool(sites), group, config, lr, spec_masks,
                    generator, [batch[k].device for k in BATCH_KEYS
                                if batch.get(k) is not None])):
                lc = config.left_context if left_context is None \
                    else left_context
                key = _StepGraphs.key(batch, num, lc, generator)
                if key in graphs.seen:
                    return _graphed(key, opt_state, scale_state, batch,
                                    generator, num, lc)
                graphs.seen[key] = None
            return _step(opt_state, scale_state, batch, generator,
                         spec_masks, lr, num_graph, left_context)

    def _graphed(key, opt_state, scale_state, batch, generator, num, lc):
        """The call as a replay of its geometry's graph, captured on the
        geometry's second call."""
        if count.seed(opt_state["step"]):
            count.blocking_reads += 1
        cap = graphs.seen[key]
        fresh = cap is None
        if fresh:
            graphs.load_state(opt_state)
            cap = graphs.static_inputs(batch, num, batch["features"].device,
                                       generator)
            graphs.capture(cap, lambda st, b, g: _step(
                st, scale_state, b, generator, None, None, g, lc,
                graphed=True)[::2])
            graphs.seen[key] = cap
            graphs.captures += 1
            # the graph's gradients stay its own: none is left on the
            # parameters to alias what a replay rewrites
            net.zero_grad(set_to_none=True)
        with span("train_step.replay"):
            if not fresh:
                graphs.load_state(opt_state)
                graphs.fill(cap, batch, num)
            outs = graphs.replay(cap, count=not fresh)
            graphs.replays += 1
        with span("train_step.read"):
            done = count.fold(graphs.skip)
        if targets and (done + 1) % interval == 0:
            graphs.constrain(constrain)
        new_opt_state = graphs.returned_state()
        count.returned = new_opt_state["step"]
        return new_opt_state, scale_state, TrainStepOutput(
            loss_scale=scale_state.scale, **outs)

    @torch.no_grad()
    def constrain(skip):
        # Kaldi applies ConstrainOrthonormal after the parameter update; a
        # skipped step keeps the old w (the skip is known on the device
        # only)
        params = net.params
        for lname, pname, c in targets:
            w = params[lname][pname]
            d = sharded_dim(specs[lname][pname])
            if d is None:
                new_w = constrain_orthonormal(w, c)
            else:
                # a sharded target (prefinal small_w): constrained whole,
                # then cut back to this rank's rows
                (whole,) = gather_over([w], [d], ax.model)
                new_w = model_slice(constrain_orthonormal(whole, c), d,
                                    ax.model.rank, ax.model.world, lname)
            w.copy_(torch.where(skip, w, new_w))

    def _step(opt_state, scale_state, batch, generator, spec_masks, lr,
              num_graph, left_context, graphed=False):
        with span("train_step.forward"):
            if num_graph is not None:
                objf_fn = make_chain_objf_with_post(num_graph, den, chain_opts)
            elif static_objf is not None:
                objf_fn = static_objf
            else:
                raise ValueError("no numerator graph: pass num_graph to "
                                 "make_train_step or to the step")
            if left_context is None:
                left_context = config.left_context
            feats, ivecs, weights, dws_arg, n_out, T_in = _batch_inputs(
                batch, config, num_frames_out, group)
            dev = feats.device
            grid, time_subsample, pick_frames = _frame_geometry(
                model, config, T_in, n_out, left_context)

            params = net.params
            old_state = net.bn_state()
            net.zero_grad(set_to_none=True)
            ng = NGContext() if sites else None
            if config.remat and generator is not None and spec_masks is None:
                spec_masks = draw_spec_masks(model, feats.shape[0],
                                             feats.shape[1], generator, dev,
                                             group)

            # the BatchNorm switch as the step starts: remat's recompute in
            # the backward runs the same BatchNorm
            bn_lowp = network_module._BN_LOWP_STATS

            chunk = chunk_times(model, config, n_out, left_context)

            def forward():
                return net(feats, ivecs, train=True, compute_dtype=dtype,
                           time_subsample=time_subsample,
                           spec_masks=spec_masks, generator=generator, ng=ng,
                           group=group, bn_lowp=bn_lowp, chunk=chunk)

            if config.remat:
                outs, new_state = torch.utils.checkpoint.checkpoint(
                    forward, use_reentrant=False)
                if ng is not None:
                    ng.frozen = True
            else:
                outs, new_state = forward()
            out = pick_frames(outs[chain_head_name].float(),
                              chain_head_name in grid)
        objf, result, num_post = objf_fn(out, weights, dws_arg)
        with span("train_step.backward"):
            loss = -objf
            xent_objf = torch.zeros((), dtype=torch.float32, device=dev)
            if xent_regularize > 0 and xent_layer is not None:
                xent = pick_frames(outs[xent_layer.name].float(),
                                   xent_layer.name in grid)
                xent = xent * dws_arg[:, :, None]
                xent_objf = torch.sum(weights[:, None, None] * num_post * xent)
                loss = loss - xent_regularize * xent_objf
            if config.use_loss_scaling:
                loss = loss * scale_state.scale
            loss.backward()
            del outs, out
            loss = loss.detach()
            # a parameter with no path to the loss (e.g. the xent head when
            # xent_regularize is 0) has a zero gradient, as under jax.grad
            grads = {l: {k: (w.grad if w.grad is not None
                             else torch.zeros_like(w)) for k, w in p.items()}
                     for l, p in params.items()}

            gs = ng.gs if ng is not None else {}
            if config.use_loss_scaling:
                loss = loss / scale_state.scale
                grads = unscale_grads(grads, scale_state)
                gs = unscale_grads(gs, scale_state)

            total_objf, total_weight = result.total_objf, result.total_weight
            num_lp = result.num_logprob.mean()
            den_lp = result.den_logprob.mean()
            ok = result.ok.all()
            if ax.dp is not None:
                # the global batch's gradients and sums, in one all-reduce;
                # the data ranks hold equal rows, so the means are the
                # ranks' means' mean (at world 1, the single process's bits)
                w = 1.0 / (ax.data.world if ax.data is not None else 1)
                grads, tot, nonfinite = all_reduce_grads(grads, _reported([
                    loss, total_objf, total_weight, num_lp * w, den_lp * w,
                    xent_objf.detach(), (~result.ok).sum()], group), ax.dp)
                loss, total_objf, total_weight, num_lp, den_lp, xent_objf = \
                    tot[:6]
                ok = tot[6] == 0

            # finiteness is judged on the raw grads, the sharded leaves' too
            finite = grads_finite(grads)
            if ax.dp is not None:
                finite = finite & (nonfinite == 0)
            if ax.model is not None:
                bad = (~finite).to(torch.float32).reshape(1)
                finite = ax.model.all_reduce(bad)[0] == 0
            if config.use_loss_scaling:
                new_scale_state, skip = update_loss_scale(scale_state, finite)
            else:
                new_scale_state, skip = scale_state, ~finite

        orth_due = False
        if not graphed:     # a graph's caller reads the flags
            with span("train_step.read"):
                # this call's skip goes to the host without a wait; the
                # last call's, folded in, makes the orthonormal flag exact
                seeded = count.seed(opt_state["step"])
                done = count.fold(skip)
                orth_due = bool(targets) and (done + 1) % interval == 0
                if sites:
                    # NG's host branch needs this call's skip and counters
                    flags = torch.stack(
                        [skip.to(torch.int64)]
                        + [opt_state["ng"][nm][side].t.to(torch.int64)
                           for nm, side in ng_keys]).tolist()
                    skip_host, counters = bool(flags[0]), flags[1:]
                if seeded or sites:
                    count.blocking_reads += 1

        new_ng = None
        if sites:
            new_ng = opt_state["ng"] if skip_host else update_ng_states(
                sites, opt_state["ng"], ng.xs, gs,
                dict(zip(ng_keys, counters)), ng_cfg_in, ng_cfg_out, ax.dp,
                ng.counts, ax.model, col_sites)
            del ng, gs
        if ax.model is not None:
            # model rank 0's replicated values on every model rank: the
            # replicated leaves' gradients, BatchNorm's new statistics,
            # the NG states updated now, the reported sums
            # (a list in the sites' order: the buffer's layout must be
            # every rank's, which a set's order is not)
            due = [] if not sites or skip_host else list(dict.fromkeys(
                nm for (nm, side), t in zip(ng_keys, counters)
                if update_due(t, ng_cfg_in if side == "in" else ng_cfg_out)))
            rep = one_replica(
                ({l: {k: g for k, g in p.items() if not sharded[l][k]}
                  for l, p in grads.items()}, new_state,
                 {nm: new_ng[nm] for nm in due},
                 [loss, total_objf, total_weight, num_lp, den_lp,
                  xent_objf]), ax.model)
            for l, p in rep[0].items():
                grads[l].update(p)
            new_state = rep[1]
            if due:
                new_ng = dict(new_ng, **rep[2])
            loss, total_objf, total_weight, num_lp, den_lp, xent_objf = \
                rep[3]
        if sites:
            with span("ng.precondition"):
                grads = apply_natural_gradient(model, sites, new_ng, grads,
                                               ng_cfg_in, specs, ax.model)
        with span("train_step.update"):
            if ax.model is None:
                grad_norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                           for g in tree_leaves(grads)))
            else:
                sq = [(torch.sum(grads[l][k].float() ** 2), sharded[l][k])
                      for l, p in grads.items() for k in p]
                part = ax.model.all_reduce(torch.stack(
                    [sum(t for t, sh in sq if sh)]))[0]
                grad_norm = torch.sqrt(sum(t for t, sh in sq if not sh) + part)

            # a skipped (non-finite) batch must not poison the BN statistics
            net.set_bn_state(tree_map(
                lambda new, old: torch.where(skip, old, new), new_state,
                old_state))

            new_params, new_opt_state, stats = sgd_update(
                params, grads,
                {k: v for k, v in opt_state.items() if k != "ng"}, sgd_cfg,
                lr=lr, hyper=hyper, trainable=trainable_mask(model, params),
                skip=skip, sharded=sharded, model_group=ax.model)
            if new_ng is not None:
                new_opt_state["ng"] = new_ng
            with torch.no_grad():
                for l, p in params.items():
                    for k, w in p.items():
                        w.copy_(new_params[l][k])
            if orth_due:
                constrain(skip)
            if not graphed:
                count.returned = new_opt_state["step"]

        return new_opt_state, new_scale_state, TrainStepOutput(
            loss=loss,
            objf_per_frame=total_objf / total_weight,
            num_logprob=num_lp,
            den_logprob=den_lp,
            xent_objf=xent_objf.detach(),
            param_change_norm=stats["param_change_norm"],
            grad_norm=grad_norm,
            loss_scale=new_scale_state.scale,
            skipped=skip,
            ok=ok,
            weight_frames=total_weight,
        )

    return _MadeStep(step, count, graphs)


def init_ng_states(model: Model, config: TrainConfig, device) -> dict:
    """{site: {"in": NGState, "out": NGState}} of a model's NG sites."""
    states = {}
    for site in ng_sites(model):
        d_in = site["in_dim"] + (1 if site["b"] is not None else 0)
        states[site["name"]] = {
            "in": init_ng_state(d_in, NGConfig(rank=config.ng_rank_in),
                                device),
            "out": init_ng_state(site["out_dim"],
                                 NGConfig(rank=config.ng_rank_out), device),
        }
    return states


def init_train_state(model: Model, generator: torch.Generator,
                     config: TrainConfig = TrainConfig(), device=None):
    """(net, opt_state, loss_scale_state), on `device` (default: the
    current CUDA device).  opt_state holds the SGD velocities and step
    count and, with natural_gradient, the sites' NG states ("ng")."""
    device = resolve_device(device)
    net = Network(model, generator, device)
    opt_state = init_sgd_state(net.params)
    if config.natural_gradient:
        opt_state["ng"] = init_ng_states(model, config, device)
    scale_state = (init_loss_scale(device=device) if config.use_loss_scaling
                   else init_loss_scale(1.0, device=device))
    return net, opt_state, scale_state


class EvalStepOutput(NamedTuple):
    objf_per_frame: torch.Tensor
    num_logprob: torch.Tensor
    den_logprob: torch.Tensor
    xent_objf: torch.Tensor
    weight_frames: torch.Tensor
    ok: torch.Tensor


def make_eval_step(model: Model, net: Network, den: DenominatorComputation,
                   chain_opts: ChainTrainingOpts = ChainTrainingOpts(),
                   config: TrainConfig = TrainConfig(),
                   num_frames_out: Optional[int] = None, group=None):
    """Held-out diagnostic step, the `nnet3-chain-compute-prob` analog:
    eval-mode forward (running BN statistics, no SpecAugment), the chain
    objective, no derivative, no update.

    eval_step(batch, num_graph, left_context=None) -> EvalStepOutput, with
    num/den weighted by the per-sequence weights objf uses.  group: a
    DataGroup; the batch is this rank's rows, the outputs the global
    batch's (one all-reduce)."""
    dtype = _compute_dtype(config)
    xent_regularize = config.xent_regularize or chain_opts.xent_regularize
    chain_head_name = model.chain_output().name
    xent_layer = model.xent_output()

    @torch.no_grad()
    def eval_step(batch, num_graph: NumeratorGraphBatch,
                  left_context: Optional[int] = None) -> EvalStepOutput:
        if left_context is None:
            left_context = config.left_context
        objf_fn = make_chain_objf_with_post(num_graph, den, chain_opts)
        feats, ivecs, weights, dws_arg, n_out, T_in = _batch_inputs(
            batch, config, num_frames_out, group)
        grid, time_subsample, pick_frames = _frame_geometry(
            model, config, T_in, n_out, left_context)
        outs, _ = net(feats, ivecs, train=False, compute_dtype=dtype,
                      time_subsample=time_subsample, group=group)
        out = pick_frames(outs[chain_head_name].float(),
                          chain_head_name in grid)
        _, result, num_post = objf_fn(out, weights, dws_arg)
        xent_objf = torch.zeros((), dtype=torch.float32, device=feats.device)
        if xent_regularize > 0 and xent_layer is not None:
            xent = pick_frames(outs[xent_layer.name].float(),
                               xent_layer.name in grid)
            xent = xent * dws_arg[:, :, None]
            xent_objf = torch.sum(weights[:, None, None] * num_post * xent)
        tot = torch.stack([
            result.total_objf, result.total_weight, torch.sum(weights),
            torch.sum(weights * result.num_logprob),
            torch.sum(weights * result.den_logprob), xent_objf,
            (~result.ok).sum().float()]).float()
        if mesh_axes(group).dp is not None:
            (tot,) = all_reduce_sum(_reported([tot], group),
                                    mesh_axes(group).dp)
        w_tot = torch.clamp(tot[2], min=1e-8)
        return EvalStepOutput(
            objf_per_frame=tot[0] / tot[1], num_logprob=tot[3] / w_tot,
            den_logprob=tot[4] / w_tot, xent_objf=tot[5],
            weight_frames=tot[2] * n_out, ok=tot[6] == 0)

    return eval_step
