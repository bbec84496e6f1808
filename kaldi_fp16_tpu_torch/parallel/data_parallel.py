"""Data, sequence and tensor parallelism over a mesh's axes: each rank's
share of the batch and of the wide heads, and the step's global
reductions as explicit collectives.

Port of kaldi_fp16_tpu/parallel/data_parallel.py (`param_shardings`
:28-60, `_batch_spec` / `shard_batch` :71-87).  The JAX package jits the
whole step with its inputs and heads sharded and lets GSPMD make every
reduction global (:1-14, :90-127); its docstring warns that per-shard
BatchNorm statistics "would silently switch" the result.  A rank here
sees only its share, so the step reduces, each in an all-reduce of one
flat buffer:

  * BatchNorm: the ranks' means, then their variances and the means'
    spread, each rank weighed by its frames (`batch_moments`, two
    all-reduces over data x seq per BN in the forward and two in the
    backward: the reductions are differentiable);
  * the gradients with the step's reported sums and the non-finite count
    (`all_reduce_grads`: one bucket over data x seq, the parameters in a
    fixed order; a gradient is the sum of its rows' and frames' parts);
  * NG-SGD's sample sums and counts (training/natural_gradient.py).

The `model` axis splits the wide matmuls as `param_shardings` says:
column-parallel heads (their input copied to the model group, `copy_to`;
their output gathered, `gather_cols`) and the row-parallel prefinal
small_w (its partial products summed, `reduce_from`).  Every BatchNorm
runs on whole channels, so its statistics are replicated.  The `seq`
axis splits the time axis: `TimeChunks` holds one frame rate's chunks,
exchanges the halos a temporal op reads (`TimeChunks.halo`: forward,
the neighbours' edge frames; backward, their gradients sent back and
added) and gathers the outputs before the loss (`TimeChunks.gather`).
Each frame lives on one rank, so BatchNorm and NG-SGD count it once.

Every rank then holds the same bits of every replicated leaf and runs the
same update (over the model axis, `one_replica` broadcasts rank 0's
replicated values once a step).  `broadcast_train_state` makes them start
so, and `shard_train_state` cuts the sharded leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_fp16_tpu_torch.parallel.mesh import (
    DataGroup, MeshConfig, mesh_axes,
)

# ---------------------------------------------------------------------------
# Sharding rules and the rank's slices
# ---------------------------------------------------------------------------

COLS, VECTOR, ROWS, REPLICATED = (None, "model"), ("model",), \
    ("model", None), ()


def _model_ranks(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, MeshConfig):
        return mesh.model
    return mesh.shape["model"]


def param_shardings(model, mesh, params) -> Dict[str, Dict[str, tuple]]:
    """Sharding rules (the JAX package's PartitionSpecs as tuples): with a
    `model` axis above 1 (mesh: a Mesh, DataGroup or MeshConfig),

        output w [in, pdfs]        -> (None, "model");  b -> ("model",)
        prefinal big_w [in, big]   -> (None, "model");  big_b -> ("model",)
        prefinal small_w [big, s]  -> ("model", None)   (follows big)
        tdnnf affine_w [2b, dim]   -> (None, "model");  affine_b -> ("model",)

    and () (replicated) for everything else."""
    # models.network imports this module, and importing models runs it
    from kaldi_fp16_tpu_torch.models.xconfig import LayerType
    tp = _model_ranks(mesh) > 1
    out = {}
    for lname, lparams in params.items():
        layer = model.layer_map.get(lname)
        rules = {}
        for pname, v in lparams.items():
            spec = REPLICATED
            if tp and layer is not None:
                if layer.type == LayerType.OUTPUT:
                    spec = COLS if v.ndim == 2 else VECTOR
                elif layer.type == LayerType.PREFINAL:
                    spec = {"big_w": COLS, "big_b": VECTOR,
                            "small_w": ROWS}.get(pname, REPLICATED)
                elif layer.type == LayerType.TDNNF:
                    spec = {"affine_w": COLS,
                            "affine_b": VECTOR}.get(pname, REPLICATED)
            rules[pname] = spec
        out[lname] = rules
    return out


def sharded_dim(spec: tuple) -> Optional[int]:
    """The axis a spec splits over `model` (None: replicated)."""
    return spec.index("model") if "model" in spec else None


def model_slice(t, dim: int, rank: int, ranks: int, name: str):
    """Model rank `rank` of `ranks`' slice of t along dim (a view);
    ValueError, naming the leaf, when the width does not divide."""
    size = t.shape[dim]
    if size % ranks:
        raise ValueError(f"{name}: width {size} not divisible by the "
                         f"model axis's {ranks} ranks")
    n = size // ranks
    return t.narrow(dim, rank * n, n)


def shard_params(params, specs, rank: int, ranks: int):
    """Rank `rank` of `ranks` model ranks' slices of a whole tree
    {layer: {name: tensor}} (parameters or velocities); replicated leaves
    pass through.  ValueError, naming the layer, when a sharded width
    does not divide by `ranks`."""
    out = {}
    for lname, p in params.items():
        out[lname] = {}
        for pname, t in p.items():
            d = sharded_dim(specs[lname][pname])
            out[lname][pname] = (t if d is None or ranks == 1 else
                                 model_slice(t, d, rank, ranks,
                                        f"{lname}/{pname}"))
    return out


def gather_over(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                group: DataGroup) -> List[torch.Tensor]:
    """Each rank's tensors[i] concatenated along dims[i] in rank order,
    on every rank: one all-reduce of a zero-filled fp32 buffer, each
    rank's slices in its own slot (exact: one contributor per slot).
    Returns fp32 tensors."""
    sizes = [t.numel() for t in tensors]
    if not tensors:
        return []
    w, r = group.world, group.rank
    buf = tensors[0].new_zeros(w * sum(sizes), dtype=torch.float32)
    off = 0
    for t, n in zip(tensors, sizes):
        buf[off + r * n:off + (r + 1) * n] = t.reshape(-1)
        off += w * n
    group.all_reduce(buf)
    out, off = [], 0
    for t, d, n in zip(tensors, dims, sizes):
        blocks = buf[off:off + w * n].view(w, *t.shape)
        out.append(torch.cat(blocks.unbind(0), dim=d))
        off += w * n
    return out


def gather_params(params, specs, group):
    """The whole tree from every model rank's slices (group: the model
    axis's DataGroup, or None: params is whole); one all-reduce."""
    if group is None:
        return {l: dict(p) for l, p in params.items()}
    keys = [(l, k) for l, p in params.items() for k in p
            if sharded_dim(specs[l][k]) is not None]
    full = gather_over([params[l][k].detach() for l, k in keys],
                       [sharded_dim(specs[l][k]) for l, k in keys], group)
    out = {l: dict(p) for l, p in params.items()}
    for (l, k), t in zip(keys, full):
        out[l][k] = t.to(params[l][k].dtype)
    return out


def _leaf_specs(model, mesh, sd) -> Dict[str, tuple]:
    """{key: spec} of the parameters in a Network's state_dict `sd`."""
    from kaldi_fp16_tpu_torch.models.network import module_key
    names = {module_key(l): l for l in model.layer_map}
    tree: Dict[str, dict] = {}
    for k, t in sd.items():
        _, key, *rest = k.split(".")
        if len(rest) == 1:                      # a parameter, not a BN buffer
            tree.setdefault(names[key], {})[rest[0]] = t
    return {f"layers.{module_key(l)}.{k}": spec
            for l, p in param_shardings(model, mesh, tree).items()
            for k, spec in p.items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], model, mesh):
    """This rank's slices of a whole state_dict of `model`'s Network (a
    checkpoint's or one process's), for a Network sharded over `mesh`."""
    ax = mesh_axes(mesh)
    if ax.model is None:
        return dict(sd)
    specs = _leaf_specs(model, mesh, sd)
    out = {}
    for k, t in sd.items():
        d = sharded_dim(specs.get(k, REPLICATED))
        out[k] = t if d is None else model_slice(t, d, ax.model.rank,
                                            ax.model.world, k).clone()
    return out


def full_state_dict(net, mesh) -> Dict[str, torch.Tensor]:
    """The whole state_dict of a Network sharded over `mesh` (one
    all-reduce over the model axis; every model rank gets it)."""
    sd = dict(net.state_dict())
    ax = mesh_axes(mesh)
    if ax.model is None:
        return sd
    specs = _leaf_specs(net.model, mesh, sd)
    keys = [k for k in sd if sharded_dim(specs.get(k, REPLICATED))
            is not None]
    full = gather_over([sd[k].detach() for k in keys],
                       [sharded_dim(specs[k]) for k in keys], ax.model)
    sd.update(zip(keys, full))
    return sd


@torch.no_grad()
def shard_train_state(net, opt_state, mesh) -> dict:
    """Cut a whole Network's sharded parameters and the SGD velocities to
    this rank's slices over the mesh's model axis, the network in place;
    returns the new opt_state (NG and step counters stay replicated, as
    the JAX package's `opt_shard`, :104-107)."""
    ax = mesh_axes(mesh)
    if ax.model is None:
        return opt_state
    specs = param_shardings(net.model, mesh, net.params)
    local = shard_params({l: {k: w.detach() for k, w in p.items()}
                          for l, p in net.params.items()}, specs,
                         ax.model.rank, ax.model.world)
    from kaldi_fp16_tpu_torch.models.network import module_key
    for lname, p in local.items():
        mod = net.layers[module_key(lname)]
        for pname, t in p.items():
            if sharded_dim(specs[lname][pname]) is not None:
                setattr(mod, pname, torch.nn.Parameter(t.clone()))
    out = dict(opt_state)
    out["velocity"] = {l: {k: v.clone() for k, v in p.items()}
                       for l, p in shard_params(opt_state["velocity"], specs,
                                                ax.model.rank,
                                                ax.model.world).items()}
    return out


def full_train_state(net, opt_state, mesh):
    """(whole state_dict, opt_state with whole velocities) of a training
    state sharded over `mesh` (two all-reduces over the model axis)."""
    ax = mesh_axes(mesh)
    sd = full_state_dict(net, mesh)
    if ax.model is None:
        return sd, opt_state
    specs = param_shardings(net.model, mesh, net.params)
    out = dict(opt_state)
    out["velocity"] = gather_params(opt_state["velocity"], specs, ax.model)
    return sd, out


# ---------------------------------------------------------------------------
# The batch
# ---------------------------------------------------------------------------

_TIME_AXIS_KEYS = ("features", "deriv_weights")


def _rows(x, group: Optional[DataGroup]):
    if group is None:
        return x
    b = x.shape[0]
    if b % group.world:
        raise ValueError(f"batch {b} not divisible by the data group's "
                         f"{group.world} ranks")
    n = b // group.world
    return x[group.rank * n:(group.rank + 1) * n]


def _frames(x, group: Optional[DataGroup], key: str):
    """This seq rank's contiguous chunk of x's time axis (axis 1)."""
    if group is None:
        return x
    t = x.shape[1]
    if t % group.world:
        raise ValueError(f"{key}: {t} frames not divisible by the seq "
                         f"axis's {group.world} ranks")
    n = t // group.world
    return x[:, group.rank * n:(group.rank + 1) * n]


def shard_batch(batch: Dict, group) -> Dict:
    """This rank's share of each array of `batch` (group: a DataGroup or
    a Mesh): its rows over the data axis (leading axis: the sequences;
    contiguous, rank 0 first) and, for features and deriv_weights, its
    frames over the seq axis (evenly split, as JAX's `_batch_spec`)."""
    ax = mesh_axes(group)
    return {k: _frames(_rows(v, ax.data), ax.seq, k)
            if k in _TIME_AXIS_KEYS and getattr(v, "ndim", 0) >= 2
            else _rows(v, ax.data) for k, v in batch.items()}


def shard_graph(g, group):
    """This rank's rows of a NumeratorGraphBatch (chain/graph.py); the
    padded sizes stay the global batch's."""
    data = mesh_axes(group).data
    return dataclasses.replace(g, **{
        f.name: _rows(getattr(g, f.name), data)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), np.ndarray)})


def shard_chain_batch(batch, group):
    """This rank's share of a ChainBatch (io/batch.py): its rows with
    their numerator graphs, and its frames of the features and
    deriv_weights over a mesh's seq axis."""
    ax = mesh_axes(group)
    graph = shard_graph(batch.num_graph, group)
    keys = np.asarray(batch.keys, dtype=object)
    return dataclasses.replace(
        batch, features=_frames(_rows(batch.features, ax.data), ax.seq,
                                "features"),
        ivectors=(None if batch.ivectors is None
                  else _rows(batch.ivectors, ax.data)),
        weights=_rows(np.asarray(batch.weights), ax.data),
        deriv_weights=(None if batch.deriv_weights is None
                       else _frames(_rows(batch.deriv_weights, ax.data),
                                    ax.seq, "deriv_weights")),
        num_graph=graph, keys=list(_rows(keys, ax.data)))


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group: DataGroup) -> List[torch.Tensor]:
    """The sums over the ranks of `tensors` (one dtype), through one
    all-reduce of a flat buffer; new tensors of the same shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    group.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


class _SumOverRanks(torch.autograd.Function):
    """y = the sum over the ranks of x; the gradient of each rank's x is
    the sum over the ranks of y's gradient (each rank's loss depends on
    every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


def batch_moments(x: torch.Tensor, group: DataGroup,
                  total: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean, biased variance, count) over the (batch, time) rows of every
    rank's x [B, T, D] (fp32), differentiable.  total: the rows of every
    rank together (default: `world` times this rank's, the global batch
    split evenly, as the JAX package shards its arrays); each rank's
    moments weigh its rows' share of it, so chunks of unequal length (the
    seq axis's grid frames) count by their frames.  One all-reduce of
    the ranks' weighted means gives the mean; one of their variances plus
    their means' squared distances from it gives the variance (the
    parallel-variance merge: no E[x^2] - E[x]^2 cancellation).  At world
    1 both are torch.mean's and torch.var's bits, those of the
    single-process BatchNorm."""
    rows = x.shape[0] * x.shape[1]
    total = rows * group.world if total is None else total
    w = rows / total
    local_mean = x.mean(dim=(0, 1))
    local_var = torch.clamp(x.var(dim=(0, 1), unbiased=False), min=0.0)
    mean = _SumOverRanks.apply(local_mean * w, group)
    var = _SumOverRanks.apply((local_var + (local_mean - mean) ** 2) * w,
                              group)
    return mean, var, float(total)


def spec_rows(masks, group, frames: Optional["TimeChunks"] = None):
    """This rank's share of SpecAugment masks drawn for the global batch:
    its rows over the data axis and, for the time mask, its frames."""
    data = mesh_axes(group).data
    f_keep, t_keep = (None if m is None else _rows(m, data) for m in masks)
    if t_keep is not None and frames is not None:
        t_keep = t_keep[:, frames.lo:frames.hi]
    return f_keep, t_keep


# ---------------------------------------------------------------------------
# The model axis: tensor-parallel collectives
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks, each of
    which has the part that flows through its columns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    """The model ranks' partial products summed; the gradient passes
    through (every rank's downstream gradient is whole)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    """The model ranks' column slices [..., c] concatenated in rank order
    [..., ranks * c]: an all-reduce of a zero-filled buffer; the gradient
    is this rank's columns of the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        c = x.shape[-1]
        buf = x.new_zeros(*x.shape[:-1], group.world, c)
        buf[..., group.rank, :] = x
        group.all_reduce(buf)
        return buf.reshape(*x.shape[:-1], group.world * c)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        c = g.shape[-1] // group.world
        return g[..., group.rank * c:(group.rank + 1) * c], None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_cols(x, group):
    return _GatherCols.apply(x, group)


# ---------------------------------------------------------------------------
# The seq axis: chunks of the time axis, halos and the gather
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimeChunks:
    """One frame rate's time axis as the mesh holds it: the sequence's T
    frames cut into contiguous chunks, bounds[s] = (lo, hi) on seq rank
    s; this rank's index s; the seq group (None: one chunk), the
    data x seq group BatchNorm and NG-SGD reduce over (None: one rank),
    and the data axis's ranks (rows of the global batch = data x this
    rank's)."""
    T: int
    bounds: Tuple[Tuple[int, int], ...]
    s: int
    seq: Optional[DataGroup]
    dp: Optional[DataGroup]
    data: int

    @staticmethod
    def even(n: int, group) -> "TimeChunks":
        """The input rate: each seq rank's n frames (shard_batch splits
        the time axis evenly)."""
        ax = mesh_axes(group)
        S = ax.seq.world if ax.seq is not None else 1
        return TimeChunks(n * S, tuple((i * n, (i + 1) * n)
                                       for i in range(S)),
                          ax.seq.rank if ax.seq is not None else 0,
                          ax.seq, ax.dp,
                          ax.data.world if ax.data is not None else 1)

    @property
    def lo(self) -> int:
        return self.bounds[self.s][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.s][1]

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def total(self, rows: int) -> int:
        """Every rank's rows of a tensor of which this rank holds `rows`
        [B, n, ...] (the global batch's B x T x ...)."""
        return rows // self.n * self.data * self.T

    def grid(self, stride: int, offset: int, n_grid: int) -> "TimeChunks":
        """The frame grid offset + k * stride, k < n_grid: each seq rank
        holds the grid frames that lie in its own chunk, so the
        full -> grid cut is local (and a cut conv's window needs only a
        halo); ValueError when a rank would hold none."""
        starts = [min(n_grid, max(0, -(-(lo - offset) // stride)))
                  for lo, _ in self.bounds] + [n_grid]
        bounds = tuple(zip(starts[:-1], starts[1:]))
        if any(hi <= lo for lo, hi in bounds):
            raise ValueError(f"grid chunks {bounds} of {n_grid} frames: a "
                             f"seq rank holds no grid frame")
        return dataclasses.replace(self, T=n_grid, bounds=bounds)

    def halo(self, x: torch.Tensor, left: int, right: int,
             mode: str) -> torch.Tensor:
        """x [B, n, ...] with `left` frames before and `right` after: the
        neighbours' edge frames (one all-reduce over seq), and at the
        sequence's ends zeros (mode 'zero') or copies of the end frame
        ('clamp'), as _shift_time fills them.  ValueError when a rank's
        chunk is shorter than the halo it must give."""
        lens = [hi - lo for lo, hi in self.bounds]
        for i, n in enumerate(lens):
            if (i + 1 < len(lens) and n < left) or (i > 0 and n < right):
                raise ValueError(f"seq rank {i}'s {n} frames are fewer than "
                                 f"the halo ({left}, {right}) it must give")
        lpart, rpart = _Halo.apply(x, self, left, right)
        last = len(self.bounds) - 1
        if self.s == 0:
            lpart = _end_fill(x[:, :1], left, mode)
        if self.s == last:
            rpart = _end_fill(x[:, -1:], right, mode)
        return torch.cat([lpart, x, rpart], dim=1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, n, ...] -> the whole sequence [B, T, ...] on every seq
        rank; the gradient is this rank's frames of the whole one."""
        return _GatherTime.apply(x, self)


def _end_fill(edge, k: int, mode: str):
    shape = (-1, k, *edge.shape[2:])
    if mode == "zero":
        return torch.zeros_like(edge).expand(shape)
    return edge.expand(shape)


class _Halo(torch.autograd.Function):
    """(left, right) halo frames of this seq rank from its neighbours:
    slot s of one zero-filled buffer per rank, which its neighbours fill
    with their edge frames (exact sums).  The backward sends the halo
    frames' gradients back the same way and adds them to the owners'."""

    @staticmethod
    def forward(ctx, x, tc, left, right):
        ctx.tc, ctx.left, ctx.right = tc, left, right
        ctx.n = x.shape[1]
        s, S, n = tc.s, len(tc.bounds), x.shape[1]
        buf = x.new_zeros(S, x.shape[0], left + right, *x.shape[2:])
        if s + 1 < S and left:
            buf[s + 1, :, :left] = x[:, n - left:]
        if s > 0 and right:
            buf[s - 1, :, left:] = x[:, :right]
        tc.seq.all_reduce(buf)
        return buf[s, :, :left].clone(), buf[s, :, left:].clone()

    @staticmethod
    def backward(ctx, g_left, g_right):
        tc, left, right, n = ctx.tc, ctx.left, ctx.right, ctx.n
        s, S = tc.s, len(tc.bounds)
        buf = g_left.new_zeros(S, g_left.shape[0], left + right,
                               *g_left.shape[2:])
        buf[s, :, :left] = g_left
        buf[s, :, left:] = g_right
        tc.seq.all_reduce(buf)
        gx = g_left.new_zeros(g_left.shape[0], n, *g_left.shape[2:])
        if s + 1 < S and left:
            gx[:, n - left:] += buf[s + 1, :, :left]
        if s > 0 and right:
            gx[:, :right] += buf[s - 1, :, left:]
        return gx, None, None, None


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tc):
        ctx.tc = tc
        buf = x.new_zeros(x.shape[0], tc.T, *x.shape[2:])
        buf[:, tc.lo:tc.hi] = x
        tc.seq.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.tc.lo:ctx.tc.hi], None


def _float_leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _float_leaves(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _float_leaves(v, out)


def _replace_leaves(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, it) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return tree.__class__(*(_replace_leaves(v, it) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace_leaves(v, it) for v in tree)
    return tree


def one_replica(tree, group: DataGroup):
    """Rank 0's floating-point tensors of `tree` (nested dicts, tuples and
    NamedTuples) on every rank of `group`, in one broadcast of a flat
    buffer; a new tree, other leaves passed through.  The model axis's
    ranks compute their replicated values (the replicated leaves'
    gradients, BatchNorm's statistics, NG-SGD's states) independently,
    each in its own process: on the H100 two such ranks' replicated
    leaves came apart in their last bits at flagship width (the same
    inputs, rounded otherwise by some kernel), which the JAX package's
    single program cannot do.  One broadcast per step keeps them one
    replica.  The tree's leaves must be in the same order on every rank
    (no sets)."""
    leaves: List[torch.Tensor] = []
    _float_leaves(tree, leaves)
    if not leaves:
        return tree
    flat = group.broadcast(torch.cat([t.reshape(-1).float()
                                      for t in leaves]), 0)
    out, i = [], 0
    for t in leaves:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return _replace_leaves(tree, iter(out))


_ALIGN = 128     # fp32 elements: 512 bytes, the CUDA caching allocator's


def all_reduce_grads(grads: Dict, stats: Sequence[torch.Tensor],
                     group: DataGroup):
    """Sum the gradients (nested dicts of fp32 tensors, in their insertion
    order: the parameters' fixed order) and the scalars `stats` over the
    ranks, with the count of non-finite gradient entries, in one
    all-reduce.  Each gradient starts 512 bytes into the buffer past the
    last, so its view is aligned as a tensor of its own would be: kernels
    that read it (norms, NG's products) then take the single process's
    paths, and world 1 keeps its bits.  Returns (grads, stats
    [len(stats)], non-finite count)."""
    leaves: List[Tuple[dict, str]] = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append((tree, k))

    out = {l: dict(p) for l, p in grads.items()}
    walk(out)
    parts, starts, i = [], [], 0
    for d, k in leaves:
        g = d[k].reshape(-1).float()
        pad = -g.numel() % _ALIGN
        parts += [g, g.new_zeros(pad)] if pad else [g]
        starts.append(i)
        i += g.numel() + pad
    flat = torch.cat(parts)
    tail = torch.stack([s.float() for s in stats]
                       + [(~torch.isfinite(flat)).sum().float()])
    flat = group.all_reduce(torch.cat([flat, tail]))
    for (d, k), j in zip(leaves, starts):
        d[k] = flat[j:j + d[k].numel()].view(d[k].shape)
    return out, flat[i:-1], flat[-1]


def broadcast_train_state(net, opt_state, scale_state,
                          group: DataGroup) -> None:
    """Rank 0's parameters, BN statistics, optimizer and loss-scale states
    onto every rank, in place."""
    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
        elif hasattr(tree, "_asdict"):
            yield from tensors(tree._asdict())
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from tensors(v)

    with torch.no_grad():
        for t in list(net.state_dict().values()) + list(
                tensors(opt_state)) + list(tensors(scale_state)):
            group.broadcast(t)
