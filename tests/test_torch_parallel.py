"""The port's data parallelism (kaldi_fp16_tpu_torch/parallel/) on gloo
ranks spawned on the CPU, against one process and the JAX package.

At tests/test_parallel.py's model (XCONFIG), B = 8, T_in = 12, fp32:

* 2 and 4 ranks equal one process on the full batch, with and without
  NG-SGD (ranks 4), over 2 steps, at test_parallel.py's bars: loss rtol
  1e-5, parameters rtol 2e-5 / atol 1e-6, bn1's running mean rtol 1e-5 /
  atol 1e-7 and every BN statistic rtol 1e-5 / atol 5e-7, NG `v` rtol
  1e-4 / atol 1e-5; so do the grid model with the
  cut conv (GRID_XCONFIG) and a model with SpecAugment, whose masks on
  each rank are the global batch's rows;
* loss scaling with one non-finite sequence on one rank: every rank skips
  and backs the scale off, as one process does;
* the ranks' parameters are bit-identical to each other, and a repeat of
  a run is bit-identical to it;
* the port's 2 ranks against the JAX `make_sharded_train_step` on a
  data = 2 mesh of conftest's virtual devices, from the same JAX state
  (convert.train_state_from_jax), at the cross-framework bars of
  tests/test_torch_train_step.py;
* the collectives per step: two all-reduces per BatchNorm in the forward
  and two in the backward, one for the gradients;
* `MultiPrefetchLoader` yields the JAX one's batches; the dryrun twin
  passes (the `model` and `seq` axes: tests/test_torch_parallel_axes.py).

All ranks of one world size run every case in one spawned process group
(a module fixture), each wait bounded by JOIN_SECONDS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.parallel import data_parallel as jax_dp
from kaldi_fp16_tpu.parallel import mesh as jax_mesh
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.convert import train_state_from_jax
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools import dryrun_multichip
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import (
    Setup, run_on_ranks, run_setup,
)
from tests.test_chain_numerator import random_fst
from tests.test_parallel import GRID_XCONFIG, XCONFIG
from tests.test_torch_train_step import PARAM, SCALAR

NUM_PDFS = 8
T_IN, T_OUT, STRIDE = 12, 4, 3
B = 8
JOIN_SECONDS = 240
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=2e-5, atol=1e-6)
BN_MEAN = dict(rtol=1e-5, atol=1e-7)        # bn1's mean, as there
NET_STATE = dict(rtol=1e-5, atol=5e-7)      # every BN statistic (its grid test)
NG_V = dict(rtol=1e-4, atol=1e-5)
SPEC_XCONFIG = XCONFIG.replace(
    "linear-component name=linear1 dim=32",
    "spec-augment-layer name=spec freq-max-proportion=0.5 "
    "time-zeroed-proportion=0.2 time-mask-max-frames=4\n"
    "linear-component name=linear1 dim=32")
TRAIN = dict(learning_rate=0.01, momentum=0.5,
             frame_subsampling_factor=STRIDE, compute_dtype="float32")


def port_graph_batch(jg):
    """A JAX NumeratorGraphBatch as the port's (the same numpy arrays)."""
    return port_graph.NumeratorGraphBatch(**{
        f.name: getattr(jg, f.name)
        for f in dataclasses.fields(port_graph.NumeratorGraphBatch)})


def make_setup(xconfig=XCONFIG, seed=21, feat_dim=16, steps=2, nan_row=None,
               **config):
    """test_parallel.py's inputs (_setup / _setup_grid): B = 8 random
    supervision FSTs and features from `seed`."""
    rng = np.random.default_rng(seed)
    csrs = [fst_to_csr(random_fst(rng, num_pdfs=NUM_PDFS, T=T_OUT,
                                  num_states=2 * (T_OUT + 1)))
            for _ in range(B)]
    feats = rng.normal(size=(B, T_IN, feat_dim)).astype(np.float32)
    if nan_row is not None:
        feats[nan_row, 4, 2] = np.nan
    return Setup(
        xconfig=xconfig,
        den_fst=port_graph.make_simple_den_fst(num_pdfs=NUM_PDFS,
                                               num_states=5, seed=9),
        num_pdfs=NUM_PDFS,
        batch={"features": feats, "weights": np.ones(B, np.float32)},
        num_graph=port_graph_batch(jax_graph.build_numerator_batch(csrs)),
        config=dict(TRAIN, **config), num_frames_out=T_OUT, steps=steps)


NG = dict(natural_gradient=True, ng_rank_in=4, ng_rank_out=4)
CASES = {
    "plain": lambda: make_setup(),
    "ng": lambda: make_setup(**NG),
    "grid": lambda: make_setup(GRID_XCONFIG, seed=33, feat_dim=8, steps=1,
                               grid_subsample=True),
    "spec": lambda: dataclasses.replace(make_setup(SPEC_XCONFIG, steps=1),
                                        spec_seed=7),
    # row 5 lies on rank 1 of 2 (rows 4-7) and on rank 2 of 4 (rows 4-5)
    "nonfinite": lambda: make_setup(steps=1, nan_row=5,
                                    use_loss_scaling=True),
}
WORLD_CASES = {2: list(CASES) + ["plain"], 4: ["plain", "ng", "nonfinite"]}


def jax_state_setup():
    """The JAX package's initial state (seed 0) for XCONFIG, and a Setup
    that starts the port from it."""
    jm = jax_build_from_string(XCONFIG)
    state = jax_ts.init_train_state(jm, jax.random.PRNGKey(0),
                                    jax_ts.TrainConfig(**TRAIN))
    tree = jax.tree_util.tree_map(np.asarray, state)
    sd, opt, scale = train_state_from_jax(
        build_model_from_string(XCONFIG), *tree, device="cpu")
    return state, dataclasses.replace(make_setup(steps=1),
                                      state=(sd, opt, scale))


@pytest.fixture(scope="module")
def jax_case():
    return jax_state_setup()


@pytest.fixture(scope="module")
def ranks(jax_case):
    """{world: {case: [rank results]}}: every case of a world size in
    one spawned gloo process group; `plain` twice under 2 ranks (the
    repeat)."""
    out = {}
    for world, names in WORLD_CASES.items():
        setups = [CASES[n]() for n in names]
        if world == 2:
            names = names + ["jax"]
            setups.append(jax_case[1])
        res = run_on_ranks(setups, world, join_seconds=JOIN_SECONDS,
                           device="cpu")
        out[world] = {}
        for i, name in enumerate(names):
            key = name if name not in out[world] else name + "_repeat"
            out[world][key] = [r[i] for r in res]
    return out


@pytest.fixture(scope="module")
def single():
    return {name: run_setup(make(), device="cpu")
            for name, make in CASES.items()}


def assert_like_one_process(got, ref):
    for o, r in zip(got["outputs"], ref["outputs"]):
        np.testing.assert_allclose(o["loss"], r["loss"], **LOSS)
        assert (o["skipped"], o["ok"]) == (r["skipped"], r["ok"])
    for k, v in ref["params"].items():
        bars = (BN_MEAN if k == "layers.bn1.bn.mean" else
                NET_STATE if k.rsplit(".", 1)[-1] in ("count", "mean", "var")
                else PARAMS)
        np.testing.assert_allclose(got["params"][k], v, **bars, err_msg=k)
    if ref["ng"] is not None:
        for site, st in ref["ng"].items():
            for side in ("in", "out"):
                a, b = got["ng"][site][side], st[side]
                assert int(a["t"]) == int(b["t"])
                np.testing.assert_allclose(a["v"], b["v"], **NG_V,
                                           err_msg=f"{site}/{side}")


@pytest.mark.parametrize("world,case", [(w, c) for w, cs in
                                        WORLD_CASES.items() for c in cs
                                        if c != "nonfinite"])
def test_ranks_equal_one_process(ranks, single, world, case):
    for got in ranks[world][case]:
        assert_like_one_process(got, single[case])


@pytest.mark.parametrize("world", sorted(WORLD_CASES))
def test_nonfinite_sequence_on_one_rank_skips_every_rank(ranks, single,
                                                         world):
    ref = single["nonfinite"]
    assert ref["outputs"][0]["skipped"]
    initial = run_setup(dataclasses.replace(CASES["nonfinite"](), steps=0),
                        device="cpu")["params"]
    for got in ranks[world]["nonfinite"]:
        out = got["outputs"][0]
        assert out["skipped"] and out["loss_scale"] == 32768.0
        assert out["loss_scale"] == ref["outputs"][0]["loss_scale"]
        for k, v in initial.items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_spec_augment_masks_are_the_global_rows(ranks, single):
    ref = single["spec"]["masks"]
    got = [r["masks"] for r in ranks[2]["spec"]]
    assert len(ref) == 1 and all(len(g) == 1 for g in got)
    for i, m in enumerate(ref[0]):
        if m is None:
            assert all(g[0][i] is None for g in got)
        else:
            np.testing.assert_array_equal(
                np.concatenate([g[0][i] for g in got]), m)


def assert_bit_identical(a, b):
    """Two runs' outputs (NaN equal to NaN) and parameters, bit for bit."""
    for x, y in zip(a["outputs"], b["outputs"]):
        assert list(x) == list(y)
        np.testing.assert_array_equal(list(x.values()), list(y.values()))
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


@pytest.mark.parametrize("world,case", [(w, c) for w, cs in
                                        WORLD_CASES.items() for c in cs])
def test_ranks_bit_identical(ranks, world, case):
    first, *rest = ranks[world][case]
    for other in rest:
        assert_bit_identical(first, other)


def test_repeat_run_bit_identical(ranks):
    for x, y in zip(ranks[2]["plain"], ranks[2]["plain_repeat"]):
        assert_bit_identical(x, y)


def test_collectives_per_step(ranks):
    # XCONFIG has 4 BatchNorms (bn1, tdnnf1, prefinal's two): 2 all-reduces
    # each in the forward and 2 in the backward, 1 for the gradients
    assert ranks[2]["plain"][0]["calls_per_step"] == [17, 17]
    # NG's update step (counters 0) adds 2 per state shape; the next does not
    ng = ranks[2]["ng"][0]["calls_per_step"]
    assert ng[0] > 17 and ng[1] == 17


def test_matches_jax_sharded_step(ranks, jax_case):
    """The port's 2 ranks against the JAX step partitioned over a data = 2
    mesh, from the same state, on the same numpy batch."""
    state, setup = jax_case
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
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=2))
    batch = jax_dp.shard_batch({k: jnp.asarray(v)
                                for k, v in setup.batch.items()}, mesh)
    sstep, placed = jax_dp.make_sharded_train_step(pure, mesh, jm, *state,
                                                   batch)
    params, net_state, _, _, out = sstep(*placed, batch,
                                         jax.random.PRNGKey(5))
    from kaldi_fp16_tpu_torch.convert import params_from_jax
    want = params_from_jax(build_model_from_string(XCONFIG),
                           jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, net_state))
    for got in ranks[2]["jax"]:
        o = got["outputs"][0]
        for name in ("loss", "objf_per_frame", "num_logprob", "den_logprob",
                     "grad_norm", "param_change_norm"):
            np.testing.assert_allclose(o[name],
                                       float(getattr(out, name)),
                                       **SCALAR, err_msg=name)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), **PARAM,
                                       err_msg=k)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_multi_prefetch_loader_matches_jax(tmp_path, workers):
    from kaldi_fp16_tpu.io import dataloader as jdl
    from kaldi_fp16_tpu_torch.io import dataloader as pdl
    from tests.test_torch_dataloader import assert_batches_equal, write_arks
    files = write_arks(tmp_path, n_files=4, per_file=6)
    kw = dict(batch_size=4, shuffle_buffer=5, seed=3)
    jl = jdl.MultiPrefetchLoader(files, jdl.DataLoaderConfig(**kw),
                                 workers=workers)
    pl = pdl.MultiPrefetchLoader(files, pdl.DataLoaderConfig(**kw),
                                 workers=workers)
    try:
        assert_batches_equal(jl, pl)
    finally:
        jl.close()
        pl.close()


def test_dryrun_twin(capsys):
    res = dryrun_multichip.main(["--ranks", "2", "--join-seconds",
                                 str(JOIN_SECONDS), "--device", "cpu"])
    assert "dryrun_multichip OK: data=2 ranks on cpu over gloo" in \
        capsys.readouterr().out
    assert res["rank_losses"][0] == res["rank_losses"][1]
    np.testing.assert_allclose(res["rank_losses"][0], res["loss"], **LOSS)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_dryrun_and_ranks_default_to_the_card():
    """Without --device the dryrun's process and ranks go to the card:
    with none here, they raise instead of running on the CPU."""
    from kaldi_fp16_tpu_torch.parallel.mesh import rank_devices
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip.main(["--ranks", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_devices(None, 2)


def test_rank_devices_on_the_cpu():
    from kaldi_fp16_tpu_torch.parallel.mesh import rank_devices
    assert rank_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="counts cards"):
        rank_devices("cpu", -1)
