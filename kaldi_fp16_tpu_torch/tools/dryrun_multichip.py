"""dryrun_multichip: a train step on N gloo ranks of a data x seq x model
mesh against the same step in one process.

    python -m kaldi_fp16_tpu_torch.tools.dryrun_multichip [--ranks 2] \\
        [--device cpu] [--backend gloo]

The twin of __graft_entry__.dryrun_multichip (:34-132), with its mesh
(:64-71): 8k ranks are data 2k x seq 2 x model 2, other even counts from
4 data n/2 x model 2, the rest data n.  Its model is the JAX dryrun's
grid-eligible one: cnn1 is a cut conv at the full->grid boundary and the
TDNN-F, prefinal and output layers run on the stride-3 grid, so the step
runs the production grid program (the strided cut-conv window, grid
BatchNorm statistics) with every rank on its rows, its frames (the halo
of the cut conv's window and of the TDNN-F splices) and its columns of
the heads.  One step at 2 sequences per data rank, bf16 compute: N
spawned ranks and one process from the same weights must give the same
loss (rtol 1e-5, tests/test_parallel.py's bar), and the ranks
bit-identical parameters (the sharded ones gathered).  It runs on the
card (one per rank over NCCL; with --backend gloo the ranks may share
cards) unless --device cpu asks for gloo ranks on the CPU.

`Setup`, `run_setup` and `run_on_ranks` drive any such case; the
parallel tests (tests/test_torch_parallel*.py) use them too.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from kaldi_fp16_tpu_torch.io.fst import Fst
from kaldi_fp16_tpu_torch.parallel.mesh import MeshConfig

LOSS_RTOL = 1e-5
# the JAX dryrun's model (__graft_entry__.py:73-83)
NUM_PDFS, T_IN, T_OUT, STRIDE = 8, 12, 4, 3
XCONFIG = f"""\
input name=input dim=16
conv-relu-batchnorm-layer name=cnn1 height-in=16 height-out=16 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=2
tdnnf-layer name=tdnnf1 dim=32 bottleneck-dim=16 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=16 big-dim=32
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""


@dataclasses.dataclass
class Setup:
    """One parallel case, all of it picklable: a model, a den FST, the
    global batch and its numerator graphs, a TrainConfig's fields, the
    steps to take.  state: (state_dict, opt_state, scale_state) to start
    from (default: init_train_state from seed 0); spec_seed: the
    SpecAugment generator's seed (None: no masks); mesh: the ranks' mesh
    (None: data = every rank); restore_dir / save_dir: a checkpoint
    directory to start from (its latest) / to save the last step in;
    nan_grad: (layer, parameter, model rank), a hook that makes that
    parameter's gradient NaN on the ranks of that model coordinate only
    (one process is model rank 0), a fault on one model rank's shard.  A
    seam for the parallel tests: a field, since the spawned ranks receive
    only the Setup's picklable fields; no run of the tool sets it."""
    xconfig: str
    den_fst: Fst
    num_pdfs: int
    batch: Dict[str, np.ndarray]
    num_graph: object                  # chain.graph.NumeratorGraphBatch
    config: dict
    num_frames_out: int
    steps: int = 1
    state: Optional[tuple] = None
    spec_seed: Optional[int] = None
    mesh: Optional[MeshConfig] = None
    restore_dir: Optional[str] = None
    save_dir: Optional[str] = None
    nan_grad: Optional[tuple] = None


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    return {k: _numpy(v) for k, v in tree.items()}


def run_setup(setup: Setup, group=None, device=None,
              meshes: Optional[dict] = None) -> dict:
    """Run `setup` on this process (group None) on `device` (default: the
    current CUDA device), or as this rank of `group` (the whole process
    group's DataGroup) on the group's device, on the mesh `setup.mesh`
    (made once per config when `meshes` caches them).  Returns numpy
    results: each step's outputs and host seconds (the step and the read
    of its outputs, which waits for the device), the final state_dict
    (whole: gathered over a model axis) and NG states, the SpecAugment
    masks the forward used (this rank's share), the collectives per step
    and, on a mesh, per axis and step, and the CUDA kernels' launches
    during the steps (the wrappers' counts; none on the CPU)."""
    import time

    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.models import network
    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        broadcast_train_state, full_state_dict, shard_batch, shard_graph,
        shard_train_state,
    )
    from kaldi_fp16_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    from kaldi_fp16_tpu_torch.tools._common import kernel_launches
    from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager
    from kaldi_fp16_tpu_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )

    device = group.device if group is not None else resolve_device(device)
    if group is not None and setup.mesh is not None and (
            setup.mesh.seq > 1 or setup.mesh.model > 1):
        meshes = {} if meshes is None else meshes
        if setup.mesh not in meshes:
            meshes[setup.mesh] = make_mesh(setup.mesh, device)
        group = meshes[setup.mesh]
    model = build_model_from_string(setup.xconfig)
    config = TrainConfig(**setup.config)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, device)
    if setup.state is not None:
        sd, opt, scale = setup.state
        net.load_state_dict(sd, strict=True)
        opt, scale = _clone(opt, device), _clone(scale, device)
    batch, graph = setup.batch, setup.num_graph
    if group is not None:
        broadcast_train_state(net, opt, scale, group)
        opt = shard_train_state(net, opt, group)
        batch, graph = shard_batch(batch, group), shard_graph(graph, group)
    if setup.restore_dir is not None:
        opt, scale, _, _ = CheckpointManager(
            setup.restore_dir, group=group).restore(None, net, opt, scale)
    if setup.nan_grad is not None:
        lname, pname, rank = setup.nan_grad
        model_axis = mesh_axes(group).model
        if (0 if model_axis is None else model_axis.rank) == rank:
            getattr(net.layers[network.module_key(lname)], pname) \
                .register_hook(lambda g: torch.full_like(g, float("nan")))
    den = DenominatorComputation(
        DenominatorGraph.from_fst(setup.den_fst, setup.num_pdfs),
        leaky=1e-4, device=device)
    step = make_train_step(model, net, den, graph, ChainTrainingOpts(),
                           config, num_frames_out=setup.num_frames_out,
                           group=group)
    gen = (None if setup.spec_seed is None
           else torch.Generator().manual_seed(setup.spec_seed))
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items()}

    masks = []
    drawn = "spec_augment_masks" if group is None else "spec_rows"
    draw = getattr(network, drawn)

    def record(*args, **kwargs):
        m = draw(*args, **kwargs)
        masks.append([None if x is None else x.cpu().numpy() for x in m])
        return m

    setattr(network, drawn, record)
    outputs, calls, axes, seconds = [], [], [], []
    counts = getattr(group, "counts", lambda: {})
    launches0 = kernel_launches()
    try:
        for _ in range(setup.steps):
            before = group.calls if group is not None else 0
            axes0 = counts()
            t0 = time.perf_counter()
            opt, scale, out = step(opt, scale, tensors, generator=gen)
            outputs.append({k: float(v) for k, v in out._asdict().items()})
            seconds.append(time.perf_counter() - t0)
            calls.append((group.calls if group is not None else 0) - before)
            axes.append({k: {n: v[n] - axes0[k][n] for n in v}
                         for k, v in counts().items()})
    finally:
        setattr(network, drawn, draw)
    launches = {k: n - launches0[k] for k, n in kernel_launches().items()}
    if setup.save_dir is not None:
        CheckpointManager(setup.save_dir, group=group).save(
            setup.steps, net, opt, scale)
    return {"outputs": outputs, "step_seconds": seconds,
            "calls_per_step": calls, "axis_counts_per_step": axes,
            "launches": launches,
            "masks": masks, "device": str(device),
            "backend": group.backend if group is not None else None,
            "mesh": getattr(group, "shape", None),
            "mesh_axes": {k: None if g is None else [g.rank, g.world,
                                                     list(g.ranks)]
                          for k, g in group.axes._asdict().items()}
            if hasattr(group, "axes") else None,
            "params": _numpy(full_state_dict(net, group)),
            "ng": _numpy(opt["ng"]) if "ng" in opt else None}


def _clone(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if hasattr(tree, "_asdict"):
        return tree.__class__(**{k: _clone(v, device)
                                 for k, v in tree._asdict().items()})
    return {k: _clone(v, device) for k, v in tree.items()}


def _run_setups(group, setups):
    meshes: dict = {}
    return [run_setup(s, group, meshes=meshes) for s in setups]


def run_on_ranks(setups: List[Setup], ranks: int,
                 join_seconds: Optional[float] = None, device=None,
                 backend: Optional[str] = None,
                 rank0_here: bool = False) -> List[List[dict]]:
    """Each setup on `ranks` ranks of one process group (on its mesh), on
    `device`'s kind (default: the cards, parallel/mesh.py's
    `rank_devices`), spawned but for rank 0 with rank0_here:
    results[rank][setup]."""
    from kaldi_fp16_tpu_torch.parallel.mesh import rank_devices, spawn_ranks
    return spawn_ranks(_run_setups, rank_devices(device, ranks, backend),
                       args=(setups,), backend=backend,
                       join_seconds=join_seconds, rank0_here=rank0_here)


def mesh_config(ranks: int) -> MeshConfig:
    """The JAX dryrun's mesh for `ranks` devices (__graft_entry__.py
    :64-71)."""
    if ranks >= 8 and ranks % 8 == 0:
        return MeshConfig(data=ranks // 4, seq=2, model=2)
    if ranks >= 4 and ranks % 2 == 0:
        return MeshConfig(data=ranks // 2, model=2)
    return MeshConfig(data=ranks)


def dryrun_setup(mesh: MeshConfig) -> Setup:
    """The JAX dryrun's case on `mesh`: 2 sequences per data rank, random
    features and linear supervision FSTs from seed 0, bf16 compute."""
    from kaldi_fp16_tpu_torch.chain.graph import (
        build_numerator_batch_from_fsts, make_simple_den_fst,
    )
    from kaldi_fp16_tpu_torch.io.fst import FstArc, FstState

    rng = np.random.default_rng(0)
    batch_size = 2 * mesh.data

    def linear_sup_fst():
        states = [FstState() for _ in range(T_OUT + 1)]
        for t in range(T_OUT):
            states[t].arcs.append(FstArc(int(rng.integers(1, NUM_PDFS + 1)),
                                         0.1, t + 1))
        states[-1].final = 0.0
        return Fst(start=0, states=states)

    graph = build_numerator_batch_from_fsts(
        [linear_sup_fst() for _ in range(batch_size)])
    return Setup(
        xconfig=XCONFIG,
        den_fst=make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=1),
        num_pdfs=NUM_PDFS,
        batch={"features": rng.normal(size=(batch_size, T_IN, 16))
               .astype(np.float32),
               "weights": np.ones(batch_size, np.float32)},
        num_graph=graph,
        config=dict(learning_rate=0.01, momentum=0.5,
                    frame_subsampling_factor=STRIDE,
                    compute_dtype="bfloat16"),
        num_frames_out=T_OUT, mesh=mesh)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.dryrun_multichip")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--join-seconds", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "the ranks take one card each)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cards, gloo on the CPU")
    args = ap.parse_args(argv)

    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.models.network import (
        conv_cut_layers, grid_layers,
    )
    model = build_model_from_string(XCONFIG)
    if not grid_layers(model, STRIDE):
        raise AssertionError("dryrun model must be grid-eligible")
    if conv_cut_layers(model, STRIDE) != frozenset({"cnn1"}):
        raise AssertionError("dryrun model must exercise the cut-conv "
                             "boundary")

    setup = dryrun_setup(mesh_config(args.ranks))
    single = run_setup(setup, device=args.device)
    ranks = [r[0] for r in run_on_ranks([setup], args.ranks,
                                        args.join_seconds, args.device,
                                        args.backend)]
    loss = single["outputs"][0]["loss"]
    losses = [r["outputs"][0]["loss"] for r in ranks]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite single-process loss {loss}")
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"the ranks' losses differ: {losses}")
    np.testing.assert_allclose(losses[0], loss, rtol=LOSS_RTOL,
                               err_msg="N ranks vs one process")
    for r in ranks[1:]:
        for k, v in r["params"].items():
            if not np.array_equal(v, ranks[0]["params"][k]):
                raise AssertionError(f"{k} differs between the ranks")
    mesh = setup.mesh
    shape = (f"data={mesh.data}" if mesh.seq == mesh.model == 1 else
             f"data={mesh.data} x seq={mesh.seq} x model={mesh.model}")
    print(f"dryrun_multichip OK: {shape} ranks on "
          f"{ranks[0]['device']} over {ranks[0]['backend']}, batch "
          f"{2 * mesh.data}, loss {losses[0]:.6f} (one process "
          f"{loss:.6f}), {ranks[0]['calls_per_step'][0]} collectives per "
          f"step, parameters bit-identical across ranks")
    return {"loss": loss, "rank_losses": losses,
            "mesh": {"data": mesh.data, "seq": mesh.seq,
                     "model": mesh.model},
            "calls_per_step": ranks[0]["calls_per_step"][0],
            "axis_counts_per_step": ranks[0]["axis_counts_per_step"][0],
            "rank_launches": {k: sum(r["launches"][k] for r in ranks)
                              for k in ranks[0]["launches"]}}


if __name__ == "__main__":
    main()
