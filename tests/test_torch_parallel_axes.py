"""The port's sequence (`seq`) and tensor (`model`) parallelism
(kaldi_fp16_tpu_torch/parallel/) on gloo ranks spawned on the CPU, against
one process and the JAX package's sharded step.

At tests/test_parallel.py's models (XCONFIG, GRID_XCONFIG), B = 8,
T_in = 12, fp32:

* the meshes (data 2, model 2), (data 1, model 4), (data 2, seq 2),
  (data 2, seq 2, model 2) and (data 4, model 2), the grid model with its
  cut conv at (data 2, seq 2) and (data 2, seq 2, model 2), and at T_in =
  14 (unequal grid chunks, with and without NG-SGD) at (data 2, seq 2),
  SpecAugment (with and without remat) and restricted attention at
  (data 2, seq 2), and NG-SGD (ranks 4) at (data 2, model 2) and
  (data 2, seq 2) equal one process over 2 steps at test_parallel.py's
  bars: loss rtol 1e-5, parameters rtol 2e-5 / atol 1e-6 (gathered
  whole), BN statistics rtol 1e-5 / atol 5e-7, NG `v` rtol 1e-4 /
  atol 1e-5;
* every rank holds the same bits of every leaf (the sharded ones
  gathered), and each rank's SpecAugment masks are its rows and frames of
  the global batch's;
* (data 2, model 2) and (data 2, seq 2, model 2) against the JAX
  `make_sharded_train_step` on conftest's virtual devices, from the same
  JAX state, at tests/test_torch_train_step.py's bars;
* the phone-LM structured den at (data 4, model 2): loss and den_logprob
  at rtol 1e-5; six steps at (data 4, model 2) lower the loss;
* a checkpoint written at (data 2, model 2) restores in one process and
  gives the step one process takes, and the reverse; the Trainer at
  (data 1, seq 2, model 2), deriv_weights and all, equals one process's;
  convert.py cuts a JAX state to a rank's shards and gathers it back;
* `param_shardings`' rules, the mesh's layout and axis groups, the
  too-many-ranks ValueError, and ValueErrors for an indivisible width, an
  indivisible time axis and a chunk shorter than its halo;
* the dryrun twin at 4 ranks (data 2 x model 2) and 8 (data 2 x seq 2 x
  model 2).

Each world size runs every case in one spawned process group (a module
fixture), each wait bounded by JOIN_SECONDS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.parallel import data_parallel as jax_dp
from kaldi_fp16_tpu.parallel import mesh as jax_mesh
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    COLS, REPLICATED, ROWS, VECTOR, TimeChunks, param_shardings, shard_batch,
    shard_params,
)
from kaldi_fp16_tpu_torch.parallel.mesh import (
    DataGroup, MeshConfig, free_address, make_mesh,
)
from kaldi_fp16_tpu_torch.tools import dryrun_multichip
from kaldi_fp16_tpu_torch.parallel.mesh import spawn_ranks
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import (
    run_on_ranks, run_setup,
)
from tests.test_parallel import GRID_XCONFIG, XCONFIG
from tests.test_torch_parallel import (
    JOIN_SECONDS, LOSS, NET_STATE as BN, NG, PARAMS, SPEC_XCONFIG, TRAIN,
    assert_bit_identical, assert_like_one_process, jax_state_setup,
    make_setup,
)
from tests.test_torch_tool_help import two_threads  # noqa: F401
from tests.test_torch_train_step import PARAM, SCALAR

NUM_PDFS, T_OUT = 8, 4
DP2_TP2 = MeshConfig(data=2, model=2)
DP2_SP2 = MeshConfig(data=2, seq=2)
DP2_SP2_TP2 = MeshConfig(data=2, seq=2, model=2)
DP4_TP2 = MeshConfig(data=4, model=2)
STEPS = 2


# XCONFIG with restricted attention after tdnnf1 (its context, 2 frames
# left and 1 right, read through a halo under seq)
ATT_XCONFIG = XCONFIG.replace(
    "prefinal-layer name=prefinal",
    "attention-relu-batchnorm-layer name=att num-heads=2 value-dim=4 "
    "key-dim=4 num-left-inputs=2 num-right-inputs=1 time-stride=1\n"
    "prefinal-layer name=prefinal")


def grid_setup(**kw):
    return make_setup(GRID_XCONFIG, seed=33, feat_dim=8, steps=STEPS,
                      grid_subsample=True, **kw)


def grid14_setup(**kw):
    """The grid model at T_in = 14: seq 2 splits its 4 grid frames 3 / 1
    (frames 0, 3, 6 | 9 of chunks 0-6 | 7-13), so BatchNorm and NG-SGD
    weigh the ranks by their frames, as at the flagship's 49 (25 / 24)."""
    setup = grid_setup(**kw)
    feats = np.random.default_rng(15).normal(size=(8, 14, 8))
    return dataclasses.replace(setup, batch=dict(
        setup.batch, features=feats.astype(np.float32)))


def den_setup(steps):
    """test_sharded_structured_denominator's phone-LM den (structured)."""
    return dataclasses.replace(
        make_setup(steps=steps),
        den_fst=port_graph.make_phone_lm_den_fst(
            num_pdfs=NUM_PDFS, num_phones=4, states_per_phone=2,
            branching=3, seed=2))


# name: (the one-process case, the mesh); the one-process case runs with
# mesh None in this process
MESH_CASES = {
    4: {"dp2_tp2": ("plain", DP2_TP2),
        "tp4": ("plain", MeshConfig(data=1, model=4)),
        "dp2_sp2": ("plain", DP2_SP2),
        "grid_dp2_sp2": ("grid", DP2_SP2),
        "grid14_dp2_sp2": ("grid14", DP2_SP2),
        "ng_grid14_dp2_sp2": ("ng_grid14", DP2_SP2),
        "spec_dp2_sp2": ("spec", DP2_SP2),
        "remat_spec_dp2_sp2": ("remat_spec", DP2_SP2),
        "att_dp2_sp2": ("att", DP2_SP2),
        "ng_dp2_tp2": ("ng", DP2_TP2),
        "nonfinite_dp2_tp2": ("nonfinite", DP2_TP2),
        "nangrad_dp2_tp2": ("nangrad", DP2_TP2),
        "ng_dp2_sp2": ("ng", DP2_SP2)},
    8: {"dp2_sp2_tp2": ("plain", DP2_SP2_TP2),
        "grid_dp2_sp2_tp2": ("grid", DP2_SP2_TP2),
        "dp4_tp2": ("plain", DP4_TP2),
        "den_dp4_tp2": ("den", DP4_TP2),
        "steps6_dp4_tp2": ("steps6", DP4_TP2)},
}
SINGLE = {"plain": lambda: make_setup(steps=STEPS),
          "grid": grid_setup,
          "grid14": grid14_setup,
          "ng_grid14": lambda: grid14_setup(**NG),
          "spec": lambda: dataclasses.replace(
              make_setup(SPEC_XCONFIG, steps=STEPS), spec_seed=7),
          # masks drawn before the checkpointed forward, cut there too
          "remat_spec": lambda: dataclasses.replace(
              make_setup(SPEC_XCONFIG, steps=STEPS, remat=True),
              spec_seed=7),
          "ng": lambda: make_setup(steps=STEPS, **NG),
          "att": lambda: make_setup(ATT_XCONFIG, steps=STEPS),
          "den": lambda: den_setup(1),
          # row 5 lies on data rank 1 of 2 (rows 4-7)
          "nonfinite": lambda: make_setup(steps=1, nan_row=5,
                                          use_loss_scaling=True),
          # the output weight's gradient NaN on model rank 1's columns
          # only (one process has no fault: it is model rank 0)
          "nangrad": lambda: dataclasses.replace(
              make_setup(steps=1, use_loss_scaling=True),
              nan_grad=("output", "w", 1)),
          "steps6": lambda: make_setup(steps=6)}
JAX_MESHES = {4: DP2_TP2, 8: DP2_SP2_TP2}


@pytest.fixture(scope="module")
def single():
    return {name: run_setup(make(), device="cpu")
            for name, make in SINGLE.items()}


@pytest.fixture(scope="module")
def jax_case():
    return jax_state_setup()


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """One process's first step saved (the checkpoint the ranks restore),
    and a directory for the ranks' first step."""
    d = tmp_path_factory.mktemp("ckpt")
    one = str(d / "one_process")
    run_setup(dataclasses.replace(make_setup(steps=1), save_dir=one),
              device="cpu")
    return {"one_process": one, "ranks": str(d / "ranks")}


@pytest.fixture(scope="module")
def ranks(jax_case, ckpt_dirs):
    """{world: {case: [rank results]}}: every case of a world size in one
    spawned gloo process group."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for world, cases in MESH_CASES.items():
            names = list(cases)
            setups = [dataclasses.replace(SINGLE[c](), mesh=m)
                      for c, m in cases.values()]
            names.append("jax")
            setups.append(dataclasses.replace(jax_case[1],
                                              mesh=JAX_MESHES[world]))
            if world == 4:
                names += ["ckpt_save", "ckpt_restore"]
                setups += [
                    dataclasses.replace(make_setup(steps=1), mesh=DP2_TP2,
                                        save_dir=ckpt_dirs["ranks"]),
                    dataclasses.replace(make_setup(steps=1), mesh=DP2_TP2,
                                        restore_dir=ckpt_dirs["one_process"])]
            res = run_on_ranks(setups, world, join_seconds=JOIN_SECONDS,
                               device="cpu")
            out[world] = {name: [r[i] for r in res]
                          for i, name in enumerate(names)}
    finally:
        torch.set_num_threads(n)
    return out


ALL_CASES = [(w, c) for w, cs in MESH_CASES.items() for c in cs]


@pytest.mark.parametrize("world,case", [(w, c) for w, c in ALL_CASES
                                        if not c.startswith(("den", "steps",
                                                             "nonfinite",
                                                             "nangrad"))])
def test_mesh_equals_one_process(ranks, single, world, case):
    ref = single[MESH_CASES[world][case][0]]
    for got in ranks[world][case]:
        assert len(got["outputs"]) == len(ref["outputs"]) == STEPS
        assert_like_one_process(got, ref)


@pytest.mark.parametrize("world,case", ALL_CASES + [(4, "jax"), (8, "jax")])
def test_every_rank_holds_the_same_bits(ranks, world, case):
    first, *rest = ranks[world][case]
    for other in rest:
        assert_bit_identical(first, other)


def test_spec_masks_are_the_ranks_rows_and_frames(ranks, single):
    """(data 2, seq 2): rank (d, s) used rows d and frames s of the masks
    one process drew for the whole batch."""
    ref = single["spec"]["masks"]
    got = ranks[4]["spec_dp2_sp2"]
    assert len(ref) == STEPS and all(len(g["masks"]) == STEPS for g in got)
    for step, (f_keep, t_keep) in enumerate(ref):
        assert f_keep is not None and t_keep is not None
        rows = np.split(np.arange(8), 2)
        frames = np.split(np.arange(t_keep.shape[1]), 2)
        for r, g in enumerate(got):
            d, s = divmod(r, 2)
            gf, gt = g["masks"][step]
            np.testing.assert_array_equal(gf, f_keep[rows[d]])
            np.testing.assert_array_equal(gt, t_keep[rows[d]][:, frames[s]])


def trainer_run(group, setup, mesh=None):
    """`setup` through the Trainer, as one ChainBatch with deriv_weights,
    in this process or as this rank of `group` on `mesh`: its losses and
    whole state_dict (numpy)."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.io.batch import ChainBatch
    from kaldi_fp16_tpu_torch.parallel.data_parallel import full_state_dict
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer
    if group is not None:
        group = make_mesh(mesh, group.device)
    model = build_model_from_string(setup.xconfig)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        setup.den_fst, setup.num_pdfs), leaky=1e-4, device="cpu")
    trainer = Trainer(model, den, TrainConfig(**setup.config), seed=0,
                      device="cpu", group=group)
    b = len(setup.batch["weights"])
    dws = np.linspace(0.5, 1.0, b * T_OUT, dtype=np.float32).reshape(b, -1)
    batch = ChainBatch(features=setup.batch["features"], ivectors=None,
                       weights=setup.batch["weights"], deriv_weights=dws,
                       num_graph=setup.num_graph, frames_per_seq=T_OUT,
                       left_context=0, keys=[str(i) for i in range(b)])
    losses = [float(trainer.train_batch(batch).loss)
              for _ in range(setup.steps)]
    return losses, {k: v.numpy() for k, v in
                    full_state_dict(trainer.net, group).items()}


def test_trainer_on_three_axes():
    """The Trainer with the global batch on (data 1, seq 2, model 2): it
    uploads each rank's frames of the features and deriv_weights and holds
    its columns of the heads; 2 steps equal one process's Trainer."""
    setup = make_setup(steps=STEPS)
    want_losses, want = trainer_run(None, setup)
    got = spawn_ranks(trainer_run, ["cpu"] * 4, args=(
        setup, MeshConfig(data=1, seq=2, model=2)), join_seconds=JOIN_SECONDS)
    for losses, params in got:
        np.testing.assert_allclose(losses, want_losses, **LOSS)
        for k, v in want.items():
            np.testing.assert_allclose(params[k], v, **(
                PARAMS if k.rsplit(".", 1)[-1] not in ("count", "mean",
                                                       "var") else BN),
                err_msg=k)


def convert_round_trip(group, tree, mesh):
    """A JAX training state cut to this rank's shards on `mesh` by
    convert.train_state_from_jax, loaded into a network sharded there,
    and gathered back whole by train_state_to_numpy: (the rank's
    output.w shape, the trees back)."""
    from kaldi_fp16_tpu_torch.convert import (
        train_state_from_jax, train_state_to_numpy,
    )
    from kaldi_fp16_tpu_torch.models.network import Network
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        shard_train_state,
    )
    mesh = make_mesh(mesh, group.device)
    model = build_model_from_string(XCONFIG)
    sd, opt, scale = train_state_from_jax(model, *tree, device="cpu",
                                          mesh=mesh)
    net = Network(model, torch.Generator().manual_seed(1), "cpu")
    shard_train_state(net, {"velocity": {}}, mesh)
    net.load_state_dict(sd, strict=True)
    return (tuple(sd["layers.output.w"].shape),
            train_state_to_numpy(net, opt, scale, mesh))


def test_convert_cuts_and_gathers_a_jax_state(jax_case):
    """convert.py from the JAX state to a rank's shards on (data 1,
    model 2), and back whole, bit for bit."""
    state, _ = jax_case
    tree = jax.tree_util.tree_map(np.asarray, state)
    got = spawn_ranks(convert_round_trip, ["cpu"] * 2,
                      args=(tree, MeshConfig(data=1, model=2)),
                      join_seconds=JOIN_SECONDS)
    want = {"params": tree[0], "net_state": tree[1],
            "velocity": tree[2]["velocity"]}
    def assert_equal(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                assert_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)

    for shape, (params, net_state, opt, _) in got:
        assert shape == (16, NUM_PDFS // 2)
        assert_equal({"params": params, "net_state": net_state,
                      "velocity": opt["velocity"]}, want, "")


def test_nonfinite_sequence_skips_every_rank(ranks, single):
    """A NaN in one data rank's rows: every rank of (data 2, model 2)
    skips the step and backs the loss scale off, as one process does, and
    keeps its initial state."""
    ref = single["nonfinite"]["outputs"][0]
    assert ref["skipped"]
    initial = run_setup(dataclasses.replace(SINGLE["nonfinite"](), steps=0),
                        device="cpu")["params"]
    for got in ranks[4]["nonfinite_dp2_tp2"]:
        out = got["outputs"][0]
        assert out["skipped"] and out["loss_scale"] == ref["loss_scale"]
        for k, v in initial.items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_nonfinite_shard_gradient_skips_every_rank(ranks):
    """A NaN gradient on model rank 1's shard of the output weight only
    (the model axis's ranks see the same rows, so only the non-finite
    flag's all-reduce over it tells model rank 0): every rank of (data 2,
    model 2) skips the step and backs the loss scale off, as one process
    with the fault does, and keeps its initial state."""
    ref = run_setup(dataclasses.replace(SINGLE["nangrad"](),
                                        nan_grad=("output", "w", 0)),
                    device="cpu")["outputs"][0]
    assert ref["skipped"]
    initial = run_setup(dataclasses.replace(SINGLE["nangrad"](), steps=0),
                        device="cpu")["params"]
    for got in ranks[4]["nangrad_dp2_tp2"]:
        out = got["outputs"][0]
        assert out["skipped"] and out["loss_scale"] == ref["loss_scale"]
        for k, v in initial.items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_structured_den_under_data_and_model(ranks, single):
    """The twin of test_sharded_structured_denominator."""
    ref = single["den"]["outputs"][0]
    for got in ranks[8]["den_dp4_tp2"]:
        out = got["outputs"][0]
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["den_logprob"], ref["den_logprob"],
                                   rtol=1e-5)


def test_multi_step_stability(ranks, single):
    """The twin of test_multi_step_stability: six steps at (data 4,
    model 2) lower the loss, as one process's do."""
    losses = [o["loss"] for o in ranks[8]["steps6_dp4_tp2"][0]["outputs"]]
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(
        losses, [o["loss"] for o in single["steps6"]["outputs"]], **LOSS)


@pytest.mark.parametrize("world", sorted(JAX_MESHES))
def test_matches_jax_sharded_step(ranks, jax_case, world):
    """The port's ranks against the JAX step partitioned over the same
    mesh shape (conftest's virtual devices), from the same state."""
    state, setup = jax_case
    cfg = JAX_MESHES[world]
    jm = jax_build_from_string(XCONFIG)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5,
                                      seed=9), NUM_PDFS), leaky=1e-4)
    g = setup.num_graph
    jgraph = jax_graph.NumeratorGraphBatch(**{
        f.name: getattr(g, f.name)
        for f in dataclasses.fields(jax_graph.NumeratorGraphBatch)})
    pure = jax_ts.make_train_step(jm, jden, jgraph, JaxOpts(),
                                  jax_ts.TrainConfig(**TRAIN),
                                  num_frames_out=T_OUT, donate=False,
                                  jit=False)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(
        data=cfg.data, seq=cfg.seq, model=cfg.model))
    batch = jax_dp.shard_batch({k: jnp.asarray(v)
                                for k, v in setup.batch.items()}, mesh)
    sstep, placed = jax_dp.make_sharded_train_step(pure, mesh, jm, *state,
                                                   batch)
    params, net_state, _, _, out = sstep(*placed, batch,
                                         jax.random.PRNGKey(5))
    want = params_from_jax(build_model_from_string(XCONFIG),
                           jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, net_state))
    for got in ranks[world]["jax"]:
        assert got["mesh"] == {"data": cfg.data, "seq": cfg.seq,
                               "model": cfg.model}
        o = got["outputs"][0]
        for name in ("loss", "objf_per_frame", "num_logprob", "den_logprob",
                     "grad_norm", "param_change_norm"):
            np.testing.assert_allclose(o[name], float(getattr(out, name)),
                                       **SCALAR, err_msg=name)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), **PARAM,
                                       err_msg=k)


def test_checkpoint_from_model_axis_restores_in_one_process(ranks, single,
                                                            ckpt_dirs):
    """The ranks' first step at (data 2, model 2), saved whole, restored in
    one process: its second step is one process's second step."""
    got = run_setup(dataclasses.replace(make_setup(steps=1),
                                        restore_dir=ckpt_dirs["ranks"]),
                    device="cpu")
    ref = single["plain"]
    np.testing.assert_allclose(got["outputs"][0]["loss"],
                               ref["outputs"][1]["loss"], **LOSS)
    assert_like_one_process(dict(got, outputs=[]), ref)


def test_checkpoint_from_one_process_restores_on_model_axis(ranks, single):
    """One process's first step restored at (data 2, model 2), each rank
    cut to its columns: the ranks' step is one process's second."""
    ref = single["plain"]
    for got in ranks[4]["ckpt_restore"]:
        np.testing.assert_allclose(got["outputs"][0]["loss"],
                                   ref["outputs"][1]["loss"], **LOSS)
        assert_like_one_process(dict(got, outputs=[]), ref)


@pytest.mark.parametrize("world,case,shape", [
    (4, "dp2_tp2", (2, 1, 2)), (4, "tp4", (1, 1, 4)),
    (4, "dp2_sp2", (2, 2, 1)), (8, "dp2_sp2_tp2", (2, 2, 2)),
    (8, "dp4_tp2", (4, 1, 2))])
def test_mesh_layout(ranks, world, case, shape):
    """The twin of test_make_mesh_shapes: rank = (d * seq + s) * model + m,
    as JAX's grid.reshape(data, seq, model); each axis group holds the
    ranks that differ only in its coordinate, data x seq those that
    differ in model only not."""
    D, S, M = shape
    grid = np.arange(world).reshape(shape)
    for r, got in enumerate(ranks[world][case]):
        assert got["mesh"] == {"data": D, "seq": S, "model": M}
        d, s, m = np.argwhere(grid == r)[0]
        axes = got["mesh_axes"]
        want = {"data": grid[:, s, m], "seq": grid[d, :, m],
                "model": grid[d, s, :], "dp": grid[:, :, m].reshape(-1)}
        for name, members in want.items():
            if len(members) == 1:
                assert axes[name] is None, name
            else:
                rank, size, ranks_ = axes[name]
                assert ranks_ == members.tolist() and size == len(members)
                assert ranks_[rank] == r


def test_make_mesh_checks_the_process_group():
    """make_mesh() is the data axis over every rank; a mesh that needs more
    ranks than the process group has raises ValueError."""
    dist.init_process_group("gloo", init_method=free_address(),
                            world_size=1, rank=0)
    try:
        group = make_mesh(device="cpu")
        assert isinstance(group, DataGroup)
        assert group.shape == {"data": 1, "seq": 1, "model": 1}
        for cfg in (MeshConfig(data=2), MeshConfig(data=1, model=2),
                    MeshConfig(data=1, seq=2, model=2)):
            with pytest.raises(ValueError, match="needs"):
                make_mesh(cfg, "cpu")
    finally:
        dist.destroy_process_group()


def test_param_sharding_rules():
    """The twin of test_param_sharding_rules: the wide heads over `model`,
    the rest replicated; no model axis: everything replicated."""
    model = build_model_from_string(GRID_XCONFIG.replace(
        "prefinal-layer", "relu-batchnorm-layer name=rb dim=16\n"
        "prefinal-layer"))
    from kaldi_fp16_tpu_torch.models.network import Network
    params = Network(model, torch.Generator().manual_seed(0), "cpu").params
    rules = param_shardings(model, DP2_TP2, params)
    assert rules["output"] == {"w": COLS, "b": VECTOR}
    assert rules["prefinal"] == {"big_w": COLS, "big_b": VECTOR,
                                 "small_w": ROWS}
    assert rules["tdnnf2"] == {"linear_w": REPLICATED, "affine_w": COLS,
                               "affine_b": VECTOR}
    assert rules["cnn1"] == {"w": REPLICATED, "b": REPLICATED}
    assert rules["rb"] == {"w": REPLICATED, "b": REPLICATED}
    for cfg in (None, DP2_SP2, MeshConfig(data=4)):
        assert all(spec == REPLICATED
                   for p in param_shardings(model, cfg, params).values()
                   for spec in p.values())
    local = shard_params({l: dict(p) for l, p in params.items()}, rules,
                         1, 2)
    assert local["output"]["w"].shape == (16, NUM_PDFS // 2)
    assert local["prefinal"]["small_w"].shape == (16, 16)
    torch.testing.assert_close(local["prefinal"]["big_w"],
                               params["prefinal"]["big_w"][:, 16:])


def test_an_indivisible_width_raises():
    model = build_model_from_string(XCONFIG)
    from kaldi_fp16_tpu_torch.models.network import Network
    params = Network(model, torch.Generator().manual_seed(0), "cpu").params
    rules = param_shardings(model, MeshConfig(data=1, model=3), params)
    with pytest.raises(ValueError, match="tdnnf1/affine_w: width 32"):
        shard_params(params, rules, 0, 3)


def fake_mesh(seq):
    """A Mesh whose seq axis has `seq` ranks, this one the last, with no
    process group (shard_batch only reads the axes)."""
    from kaldi_fp16_tpu_torch.parallel.mesh import Axes, Mesh
    group = DataGroup(seq - 1, seq, "cpu", "gloo")
    return Mesh(MeshConfig(seq=seq), group,
                Axes(data=None, seq=group, model=None, dp=group))


def test_mesh_shards_the_time_axis():
    batch = {"features": np.arange(2 * 4).reshape(2, 4, 1),
             "deriv_weights": np.arange(2 * 2).reshape(2, 2),
             "weights": np.ones(2)}
    got = shard_batch(batch, fake_mesh(seq=2))
    np.testing.assert_array_equal(got["features"], batch["features"][:, 2:])
    np.testing.assert_array_equal(got["deriv_weights"],
                                  batch["deriv_weights"][:, 1:])
    np.testing.assert_array_equal(got["weights"], batch["weights"])


def test_an_indivisible_time_axis_raises():
    batch = {"features": np.zeros((4, 12, 3), np.float32),
             "deriv_weights": np.ones((4, 5), np.float32)}
    with pytest.raises(ValueError, match="deriv_weights: 5 frames"):
        shard_batch(batch, fake_mesh(seq=2))


def test_a_chunk_shorter_than_its_halo_raises():
    """Seq rank 1's 2 frames cannot give rank 0 a right halo of 3; nothing
    is exchanged before the check."""
    seq = DataGroup(0, 2, "cpu", "gloo")
    tc = TimeChunks(5, ((0, 3), (3, 5)), 0, seq, None, 1)
    with pytest.raises(ValueError, match="seq rank 1's 2 frames"):
        tc.halo(torch.zeros(1, 3, 2), 0, 3, "zero")
    grid = TimeChunks(12, ((0, 6), (6, 12)), 0, seq, None, 1)
    with pytest.raises(ValueError, match="holds no grid frame"):
        grid.grid(stride=9, offset=0, n_grid=1)


@pytest.mark.parametrize("n,mesh", [(4, DP2_TP2), (8, DP2_SP2_TP2)])
def test_dryrun_twin(capsys, two_threads, n, mesh):  # noqa: F811
    res = dryrun_multichip.main(["--ranks", str(n), "--join-seconds",
                                 str(JOIN_SECONDS), "--device", "cpu"])
    assert (f"dryrun_multichip OK: data={mesh.data} x seq={mesh.seq} x "
            f"model={mesh.model} ranks on cpu over gloo"
            in capsys.readouterr().out)
    assert res["mesh"] == {"data": mesh.data, "seq": mesh.seq,
                           "model": mesh.model}
    assert len(set(res["rank_losses"])) == 1
    np.testing.assert_allclose(res["rank_losses"][0], res["loss"], **LOSS)
    assert res["axis_counts_per_step"]["model"]["calls"] > 0
