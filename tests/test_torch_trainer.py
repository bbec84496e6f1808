"""The production loop of the port against the JAX package's.

* The NG-SGD train step (xent head, loss scaling, deriv weights, the
  orthonormal constraint) against the JAX step, in fp32, from the same
  state (the JAX `init_train_state`, carried across by
  `convert.train_state_from_jax`), after 1 and 5 steps, at
  tests/test_torch_train_step.py's bars: rtol 2e-4 / atol 2e-5 on the
  scalars, 1e-4 / 1e-5 on the parameters.  Two NG updates fall in those
  5 steps (counters 0 and 4); the NG states are compared by their
  invariants (d, rho, t), not by V, and the velocities (preconditioned
  gradients) within 1e-4 of each tensor's largest entry.  The NG ranks are
  4: at the default ranks every narrow site keeps half its dimensions
  (r = D/2), and a near-tie between the kept and the dropped eigenvalues
  leaves V's span to fp32 rounding in both frameworks.  A non-finite
  batch skips, and its NG counters do not advance.
* The patch-lowered conv (irregular offsets, and the NG path) against
  JAX's forward.
* A JAX checkpoint (orbax, saved and restored on the CPU) carried across
  by convert.py: the next step equals JAX's.

The Trainer and the train tool: tests/test_torch_train_tool.py.
"""


import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.convert import (
    data_position_from_jax, params_from_jax, params_to_numpy,
    train_state_from_jax, train_state_to_numpy,
)
from kaldi_fp16_tpu_torch.models import network as port_net
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.training import train_step as port_ts
from tests.test_chain_numerator import random_fst
from tests.test_torch_train_step import (
    DEN_KW, LEFT, P, PARAM, SCALAR, STRIDE, XCONFIG, _flat,
)

# a little more data per NG site than test_torch_train_step.py's batch: the
# out-factor's rho is tr F - sum(top eigenvalues), which cancels when a
# site sees fewer samples than twice its rank
B, T_IN = 4, 30
T_OUT = (T_IN - LEFT + STRIDE - 1) // STRIDE
SCALARS = ("loss", "objf_per_frame", "num_logprob", "den_logprob",
           "xent_objf", "grad_norm", "param_change_norm", "loss_scale")
NG_CFG = dict(learning_rate=0.005, momentum=0.9, frame_subsampling_factor=STRIDE,
              left_context=LEFT, compute_dtype="float32",
              orthonormal_interval=4, natural_gradient=True,
              xent_regularize=0.1, use_loss_scaling=True, ng_rank_in=4,
              ng_rank_out=4)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init_train_state(model, key, config):
    """The JAX `init_train_state`, with each site's initial NG states made
    by the port's `init_ng_state` (JAX's own runs each site's eigensolve op
    by op, ~20 s here; tests/test_torch_natural_gradient.py holds the two
    inits equal): both frameworks then start from the same states."""
    import dataclasses
    from kaldi_fp16_tpu.training.natural_gradient import NGState
    from kaldi_fp16_tpu_torch.training.natural_gradient import (
        NGConfig, init_ng_state,
    )
    params, net_state, opt, scale = jax_ts.init_train_state(
        model, key, dataclasses.replace(config, natural_gradient=False))
    if config.natural_gradient:
        def state(dim, rank):
            st = init_ng_state(dim, NGConfig(rank=rank), "cpu")
            return NGState(*(jnp.asarray(x.numpy()) for x in st))
        opt["ng"] = {
            site["name"]: {
                "in": state(site["in_dim"] + (site["b"] is not None),
                            config.ng_rank_in),
                "out": state(site["out_dim"], config.ng_rank_out)}
            for site in jax_net.ng_sites(model)}
    return params, net_state, opt, scale


def assert_ng_states_close(pstates, jstates):
    """NG states by their invariants (V is defined up to sign): the
    counters exactly, d and rho within 1e-4 of the top eigenvalue d + rho
    (rho is a difference of near-equal fp32 sums, tr F - sum(top
    eigenvalues), so its own relative error can be far larger)."""
    for site, st in jstates.items():
        for side in ("in", "out"):
            j, p = st[side], pstates[site][side]
            assert int(p.t) == int(j.t), (site, side)
            jd = np.asarray(j.d)
            top = float(jd.max()) + float(j.rho)
            np.testing.assert_allclose(
                p.d.detach().cpu().numpy(), jd, rtol=1e-4, atol=1e-4 * top,
                err_msg=f"{site}/{side}/d")
            np.testing.assert_allclose(float(p.rho), float(j.rho), rtol=0,
                                       atol=1e-4 * top,
                                       err_msg=f"{site}/{side}/rho")


def assert_params_close(net, jparams, jstate):
    pparams, pstate = params_to_numpy(net)
    jp, js = _flat(tree_np(jparams)), _flat(tree_np(jstate))
    for k, v in _flat(pparams).items():
        np.testing.assert_allclose(v, jp[k], **PARAM, err_msg=k)
    for k, v in _flat(pstate).items():
        np.testing.assert_allclose(v, js[k], **PARAM, err_msg=k)


def assert_outputs_close(pout, jout):
    for name in SCALARS:
        np.testing.assert_allclose(
            getattr(pout, name).detach().cpu().numpy(),
            np.asarray(getattr(jout, name)), **SCALAR, err_msg=name)
    assert bool(pout.skipped) == bool(jout.skipped)
    assert bool(pout.ok) == bool(jout.ok)


@pytest.fixture(scope="module")
def ng_pair():
    """A JAX NG train step and the port's, from one JAX initial state."""
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (T_OUT + 1),
                                  num_pdfs=P, T=T_OUT)) for _ in range(B)]
    batch = {"features": rng.normal(size=(B, T_IN, 8)).astype(np.float32),
             "ivectors": rng.normal(size=(B, 10)).astype(np.float32),
             "weights": np.array([1.0, 0.7, 0.9, 1.2], np.float32),
             "deriv_weights": rng.uniform(size=(B, T_OUT)).astype(np.float32)}
    jm = jax_build_from_string(XCONFIG)
    jcfg = jax_ts.TrainConfig(**NG_CFG)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5)
    jstep = jax_ts.make_train_step(
        jm, jden, jax_graph.build_numerator_batch(csrs), JaxOpts(), jcfg,
        num_frames_out=T_OUT, donate=False)
    jstate0 = tree_np(jax_init_train_state(jm, jax.random.PRNGKey(0), jcfg))
    pm = build_model_from_string(XCONFIG)
    pden = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    return dict(jm=jm, pm=pm, jstep=jstep, jstate0=jstate0, pden=pden,
                num_graph=port_graph.build_numerator_batch(csrs), batch=batch,
                jden=jden, jgraph=jax_graph.build_numerator_batch(csrs))


def port_from_jax(pair, jstate, per_call_graph=False, cfg=NG_CFG):
    """The port's network, step and states at a JAX training state."""
    pm = pair["pm"]
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    sd, opt, scale = train_state_from_jax(pm, *jstate, device="cpu")
    net.load_state_dict(sd, strict=True)
    step = port_ts.make_train_step(
        pm, net, pair["pden"],
        None if per_call_graph else pair["num_graph"], ChainTrainingOpts(),
        port_ts.TrainConfig(**cfg), num_frames_out=T_OUT)
    if per_call_graph:
        inner = step

        def step(opt, scale, batch):
            return inner(opt, scale, batch, num_graph=pair["num_graph"],
                         left_context=LEFT)
    return net, step, opt, scale


@pytest.fixture(scope="module")
def ng_run(ng_pair):
    """5 NG steps of both, outputs and states kept after steps 1 and 5."""
    jstate = list(ng_pair["jstate0"])
    net, pstep, opt, scale = port_from_jax(ng_pair, jstate,
                                           per_call_graph=True)
    jbatch = {k: jnp.asarray(v) for k, v in ng_pair["batch"].items()}
    pbatch = {k: torch.from_numpy(v) for k, v in ng_pair["batch"].items()}
    key = jax.random.PRNGKey(1)
    snaps = {}
    for i in range(1, 6):
        key, sub = jax.random.split(key)
        *jstate, jout = ng_pair["jstep"](*jstate, jbatch, sub)
        opt, scale, pout = pstep(opt, scale, pbatch)
        if i in (1, 5):
            snaps[i] = dict(jout=jout, pout=pout, jstate=tree_np(jstate),
                            params=params_to_numpy(net),
                            opt=train_state_to_numpy(net, opt, scale)[2],
                            ng=opt["ng"])
    return snaps


@pytest.mark.parametrize("steps", [1, 5])
def test_ng_train_step_matches_jax(ng_run, steps):
    s = ng_run[steps]
    assert_outputs_close(s["pout"], s["jout"])
    assert not bool(s["pout"].skipped) and bool(s["pout"].ok)
    jparams, jnet_state, jopt, _ = s["jstate"]
    pparams, pstate = s["params"]
    jp, js = _flat(jparams), _flat(jnet_state)
    for k, v in _flat(pparams).items():
        np.testing.assert_allclose(v, jp[k], **PARAM, err_msg=k)
    for k, v in _flat(pstate).items():
        np.testing.assert_allclose(v, js[k], **PARAM, err_msg=k)
    # velocities (the NG-preconditioned gradients, in the JAX layout)
    # at test_torch_natural_gradient.py's bar, relative to each tensor's
    # scale; step counts; NG states by their invariants
    jv = _flat(jopt["velocity"])
    for k, v in _flat(s["opt"]["velocity"]).items():
        np.testing.assert_allclose(v, jv[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(jv[k]).max(), err_msg=k)
    assert int(s["opt"]["step"]) == int(jopt["step"]) == steps
    assert_ng_states_close(s["ng"], jopt["ng"])


def test_ng_non_finite_batch_skips_and_keeps_ng_state(ng_pair):
    jstate = list(ng_pair["jstate0"])
    net, pstep, opt, scale = port_from_jax(ng_pair, jstate)
    batch = dict(ng_pair["batch"])
    batch["features"] = batch["features"].copy()
    batch["features"][1, 4, 2] = np.nan
    before = params_to_numpy(net)
    *jnew, jout = ng_pair["jstep"](*jstate, {k: jnp.asarray(v) for k, v in
                                             batch.items()},
                                   jax.random.PRNGKey(1))
    new_opt, _, pout = pstep(opt, scale,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert bool(pout.skipped) and bool(jout.skipped)
    assert float(pout.loss_scale) == float(jout.loss_scale) == 32768.0
    for site, st in new_opt["ng"].items():
        for side in ("in", "out"):
            assert int(st[side].t) == int(jnew[2]["ng"][site][side].t) == 0
            assert torch.equal(st[side].v, opt["ng"][site][side].v)
    after = params_to_numpy(net)
    for b, a in zip(before, after):
        fb, fa = _flat(b), _flat(a)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_ng_step_with_an_unused_xent_head_matches_jax(ng_pair):
    """NG-SGD at xent_regularize 0 on a model with an xent head (bench.py's
    step on the flagship model): the head's sites have no path to the
    loss, and their output-derivative samples are zeros, as the gradient
    of the JAX package's tap is there."""
    cfg = dict(NG_CFG, xent_regularize=0.0)
    jstep = jax_ts.make_train_step(
        ng_pair["jm"], ng_pair["jden"], ng_pair["jgraph"], JaxOpts(),
        jax_ts.TrainConfig(**cfg), num_frames_out=T_OUT, donate=False)
    jstate = list(ng_pair["jstate0"])
    _, pstep, opt, scale = port_from_jax(ng_pair, jstate, cfg=cfg)
    *jnew, jout = jstep(*jstate, {k: jnp.asarray(v) for k, v in
                                  ng_pair["batch"].items()},
                        jax.random.PRNGKey(1))
    opt, _, pout = pstep(opt, scale, {k: torch.from_numpy(v) for k, v in
                                      ng_pair["batch"].items()})
    assert_outputs_close(pout, jout)
    assert_ng_states_close(opt["ng"], tree_np(jnew[2])["ng"])


IRREGULAR = """
input name=input dim=12
conv-relu-batchnorm-layer name=cnn1 height-in=6 height-out=6 time-offsets=-3,0,1 height-offsets=-1,0,1 num-filters-in=2 num-filters-out=3
conv-relu-batchnorm-layer name=cnn2 height-in=6 height-out=3 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-2,0,1 num-filters-out=4
output-layer name=output include-log-softmax=false dim=5
"""


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_patch_conv_irregular_offsets_matches_jax(train):
    jm, pm = jax_build_from_string(IRREGULAR), build_model_from_string(
        IRREGULAR)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(2))
    x = np.random.default_rng(2).normal(size=(3, 11, 12)).astype(np.float32)
    fwd = jax.jit(lambda p, s, f, train: jax_net.forward(
        jm, p, s, f, train=train, compute_dtype=jnp.float32),
        static_argnums=3)
    _, state = fwd(params, state, jnp.asarray(x), True)
    jout, _ = fwd(params, state, jnp.asarray(x), train)
    net = port_net.Network(pm, torch.Generator(), "cpu")
    net.load_state_dict(params_from_jax(pm, tree_np(params), tree_np(state)))
    pout, _ = net(torch.from_numpy(x), train=train,
                  compute_dtype=torch.float32)
    np.testing.assert_allclose(pout["output"].detach().numpy(),
                               np.asarray(jout["output"]), rtol=1e-4,
                               atol=1e-4)


def test_ng_forward_takes_the_patch_lowering(ng_pair):
    """With an NGContext the convs run as patch matmuls, equal to the
    direct conv and to JAX's NG forward; X and G are kept per site."""
    jm, pm = ng_pair["jm"], ng_pair["pm"]
    jparams, jnet_state = ng_pair["jstate0"][:2]
    net = port_net.Network(pm, torch.Generator(), "cpu")
    net.load_state_dict(params_from_jax(pm, jparams, jnet_state))
    feats = torch.from_numpy(ng_pair["batch"]["features"])
    ivecs = torch.from_numpy(ng_pair["batch"]["ivectors"])
    ts = (STRIDE, LEFT % STRIDE, (T_IN - STRIDE) // STRIDE + 1)
    ng = port_net.NGContext()
    outs, _ = net(feats, ivecs, train=True, compute_dtype=torch.float32,
                  time_subsample=ts, ng=ng)
    direct, _ = net(feats, ivecs, compute_dtype=torch.float32,
                    time_subsample=ts)
    sites = port_net.ng_sites(pm)
    # the JAX registry also holds each site's tap shape, which the port
    # has no use for (its G comes from a hook, not a tap)
    assert sites == [{k: v for k, v in s.items() if k != "tap"}
                     for s in jax_net.ng_sites(jm)]
    assert set(ng.xs) == {s["name"] for s in sites}
    assert ng.xs["cnn1/w"].shape == (B, T_IN, 8, 9 * 3)      # the patch
    jouts, _, jxs = jax.jit(lambda p, s, f, i: jax_net.forward(
        jm, p, s, f, i, train=True, compute_dtype=jnp.float32,
        collect_ng=True, time_subsample=ts))(
        ng_pair["jstate0"][0], ng_pair["jstate0"][1],
        jnp.asarray(feats.numpy()), jnp.asarray(ivecs.numpy()))
    for name in ("output", "output-xent"):
        np.testing.assert_allclose(outs[name].detach().numpy(),
                                   np.asarray(jouts[name]), rtol=1e-4,
                                   atol=1e-4)
    # in eval mode (running BN statistics) the patch lowering, with cnn2
    # at full rate, equals the direct one with cnn2 cut (in train mode a
    # cut conv's BN pools only the grid frames)
    ev_ng, _ = net(feats, ivecs, compute_dtype=torch.float32,
                   time_subsample=ts, ng=port_net.NGContext())
    np.testing.assert_allclose(ev_ng["output"].detach().numpy(),
                               direct["output"].detach().numpy(), rtol=1e-4,
                               atol=1e-4)
    for name, x in jxs.items():
        np.testing.assert_allclose(ng.xs[name].numpy(), np.asarray(x),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    outs["output"].sum().backward()
    assert ng.gs["output/w"].shape == outs["output"].shape
    assert ng.gs["cnn1/w"].shape == (B, T_IN, 8, 4)


def test_jax_orbax_checkpoint_carries_across(ng_pair, tmp_path):
    """Two JAX NG steps, an orbax save and restore, convert.py: the next
    step of the port equals the next JAX step."""
    from kaldi_fp16_tpu.training.checkpoint import (
        CheckpointManager as JaxCkpt, DataPosition as JaxPos,
    )
    jstate = list(ng_pair["jstate0"])
    jbatch = {k: jnp.asarray(v) for k, v in ng_pair["batch"].items()}
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, sub = jax.random.split(key)
        *jstate, _ = ng_pair["jstep"](*jstate, jbatch, sub)
    mgr = JaxCkpt(str(tmp_path / "orbax"))
    mgr.save(2, *jstate, JaxPos(epoch=1, batches_consumed=2,
                                rng_key=np.asarray(key)))
    *restored, step, pos = mgr.restore(None, *ng_pair["jstate0"])
    mgr.close()
    assert step == 2 and pos.batches_consumed == 2
    net, pstep, opt, scale = port_from_jax(ng_pair, tree_np(restored))
    assert int(opt["step"]) == 2
    port_pos = data_position_from_jax(pos)
    assert (port_pos.epoch, port_pos.file_index,
            port_pos.batches_consumed) == (1, 0, 2)
    assert port_pos.rng_state is None     # a JAX key has no torch form
    key, sub = jax.random.split(key)
    *jstate, jout = ng_pair["jstep"](*jstate, jbatch, sub)
    opt, scale, pout = pstep(opt, scale, {k: torch.from_numpy(v) for k, v in
                                          ng_pair["batch"].items()})
    assert_outputs_close(pout, jout)
    assert_params_close(net, jstate[0], jstate[1])
    assert_ng_states_close(opt["ng"], tree_np(jstate[2])["ng"])
