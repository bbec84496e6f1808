"""The PyTorch port's train step against the JAX package's.

Both start from the same parameters (JAX `init_train_state`, loaded with
`params_from_jax`), see the same batch and graphs, and compute in fp32.
After 1 step and after 4 (the 4th applies the orthonormal constraint), the
loss, grad_norm, param_change_norm and every parameter must agree.  The
two frameworks sum in different orders, and the differences pass through
the chain derivative (den posterior bar 2e-4, tests/test_pallas_den_matmul.py)
and up to four SGD updates: rtol 2e-4 / atol 2e-5 on the scalars and 1e-4 /
1e-5 on the parameters (changes per step are ~1e-2).
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
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import Network
from kaldi_fp16_tpu_torch.training import train_step as port_ts
from kaldi_fp16_tpu_torch.training.optimizer import init_sgd_state
from kaldi_fp16_tpu_torch.training.loss_scale import (
    init_loss_scale, tree_leaves,
)
from tests.test_chain_numerator import random_fst

SCALAR = dict(rtol=2e-4, atol=2e-5)
PARAM = dict(rtol=1e-4, atol=1e-5)
P, B, T_IN, STRIDE, LEFT = 12, 2, 18, 3, 3
T_OUT = (T_IN - LEFT + STRIDE - 1) // STRIDE
# the narrow flagship shape of tests/test_torch_network.py, no spec-augment
XCONFIG = f"""
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-batchnorm, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 l2-regularize=0.03 learning-rate-factor=0.333 max-change=0.25 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 l2-regularize=0.03 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf4 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim={P} l2-regularize=0.015
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim={P} learning-rate-factor=5.0
"""
DEN_KW = dict(num_pdfs=P, num_phones=7, states_per_phone=2, branching=3,
              seed=2)


def _setup(config_kw, nan_features=False, deriv_weights=False):
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (T_OUT + 1),
                                  num_pdfs=P, T=T_OUT)) for _ in range(B)]
    feats = rng.normal(size=(B, T_IN, 8)).astype(np.float32)
    if nan_features:
        feats[1, 4, 2] = np.nan
    np_batch = {"features": feats,
                "ivectors": rng.normal(size=(B, 10)).astype(np.float32),
                "weights": np.array([1.0, 0.7], np.float32)}
    if deriv_weights:
        np_batch["deriv_weights"] = rng.uniform(
            size=(B, T_OUT)).astype(np.float32)
    cfg = dict(learning_rate=0.01, momentum=0.9,
               frame_subsampling_factor=STRIDE, left_context=LEFT,
               compute_dtype="float32", orthonormal_interval=4, **config_kw)

    jm = jax_build_from_string(XCONFIG)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5)
    jcfg = jax_ts.TrainConfig(**cfg)
    jstep = jax_ts.make_train_step(
        jm, jden, jax_graph.build_numerator_batch(csrs), JaxOpts(), jcfg,
        num_frames_out=T_OUT, donate=False)
    jstate = list(jax_ts.init_train_state(jm, jax.random.PRNGKey(0), jcfg))

    pm = build_model_from_string(XCONFIG)
    net = Network(pm, torch.Generator().manual_seed(0), "cpu")
    net.load_state_dict(params_from_jax(
        pm, jax.tree_util.tree_map(np.asarray, jstate[0]),
        jax.tree_util.tree_map(np.asarray, jstate[1])), strict=True)
    pden = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    pcfg = port_ts.TrainConfig(**cfg)
    pstep = port_ts.make_train_step(
        pm, net, pden, port_graph.build_numerator_batch(csrs),
        ChainTrainingOpts(), pcfg, num_frames_out=T_OUT)
    return jstep, jstate, pstep, net, np_batch, pcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _run(steps, config_kw=(), **kw):
    jstep, jstate, pstep, net, np_batch, pcfg = _setup(dict(config_kw), **kw)
    opt = init_sgd_state(net.params)
    scale = (init_loss_scale(device="cpu") if pcfg.use_loss_scaling
             else init_loss_scale(1.0, device="cpu"))
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    key = jax.random.PRNGKey(1)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        *jstate, jout = jstep(*jstate, jbatch, sub)
        opt, scale, pout = pstep(opt, scale, pbatch)
        for name in ("loss", "objf_per_frame", "num_logprob", "den_logprob",
                     "xent_objf", "grad_norm", "param_change_norm",
                     "loss_scale"):
            np.testing.assert_allclose(
                getattr(pout, name).detach().numpy(),
                np.asarray(getattr(jout, name)), **SCALAR, err_msg=name)
        assert bool(pout.skipped) == bool(jout.skipped)
        assert bool(pout.ok) == bool(jout.ok)
    assert int(opt["step"]) == int(jstate[2]["step"])
    pparams, pstate = params_to_numpy(net)
    jp = _flat(jax.tree_util.tree_map(np.asarray, jstate[0]))
    for k, v in _flat(pparams).items():
        np.testing.assert_allclose(v, jp[k], **PARAM, err_msg=k)
    js = _flat(jax.tree_util.tree_map(np.asarray, jstate[1]))
    for k, v in _flat(pstate).items():
        np.testing.assert_allclose(v, js[k], **PARAM, err_msg=k)
    return jout, pout, net


@pytest.mark.parametrize("steps", [1, 4])
def test_steps_match_jax(steps):
    _, pout, _ = _run(steps)
    assert not bool(pout.skipped) and bool(pout.ok)


def test_xent_head_loss_scaling_and_deriv_weights_match_jax():
    jout, pout, _ = _run(1, {"xent_regularize": 0.1,
                             "use_loss_scaling": True}, deriv_weights=True)
    assert float(pout.xent_objf) != 0.0


def test_non_finite_batch_skips_and_keeps_bn_state():
    jstep, jstate, pstep, net, np_batch, _ = _setup({}, nan_features=True)
    before_p, before_s = params_to_numpy(net)
    opt = init_sgd_state(net.params)
    opt, _, pout = pstep(opt, init_loss_scale(1.0, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in np_batch.items()})
    *_, jout = jstep(*jstate, {k: jnp.asarray(v) for k, v in np_batch.items()},
                     jax.random.PRNGKey(1))
    assert bool(pout.skipped) and bool(jout.skipped)
    assert int(opt["step"]) == 0
    after_p, after_s = params_to_numpy(net)
    for before, after in ((before_p, after_p), (before_s, after_s)):
        fb, fa = _flat(before), _flat(after)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert not any(v.any() for v in tree_leaves(opt["velocity"]))


def _check_params(net, jstate):
    pparams, pstate = params_to_numpy(net)
    for mine, theirs in ((pparams, jstate[0]), (pstate, jstate[1])):
        want = _flat(jax.tree_util.tree_map(np.asarray, theirs))
        for k, v in _flat(mine).items():
            np.testing.assert_allclose(v, want[k], **PARAM, err_msg=k)


def _spy_constraint(monkeypatch):
    """(now, seen): seen lists the calls on which the step computed the
    orthonormal constraint, each once, by the number now[0] holds."""
    now, seen = [0], []
    real = port_ts.constrain_orthonormal

    def spy(w, c):
        if not seen or seen[-1] != now[0]:
            seen.append(now[0])
        return real(w, c)
    monkeypatch.setattr(port_ts, "constrain_orthonormal", spy)
    return now, seen


@pytest.mark.parametrize("bad_call, computed", [(2, [5]), (4, [4, 5])])
def test_orthonormal_falls_on_the_fourth_non_skipped_step(
        monkeypatch, bad_call, computed):
    """Six calls, a non-finite batch at `bad_call`: the constraint is due
    on the 4th non-skipped step, call 5 either way.  At bad_call 4 it was
    due on the skipped call too, computed there (the skip is known on the
    device only) and selected away.  Every call's outputs and parameters
    match JAX's, and only the first call reads the device's step count."""
    jstep, jstate, pstep, net, np_batch, _ = _setup({})
    bad = dict(np_batch, features=np_batch["features"].copy())
    bad["features"][1, 4, 2] = np.nan
    now, seen = _spy_constraint(monkeypatch)
    opt = init_sgd_state(net.params)
    scale = init_loss_scale(1.0, device="cpu")
    key = jax.random.PRNGKey(1)
    for call in range(1, 7):
        now[0] = call
        batch = bad if call == bad_call else np_batch
        key, sub = jax.random.split(key)
        *jstate, jout = jstep(*jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, sub)
        opt, scale, pout = pstep(opt, scale, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        assert bool(pout.skipped) == bool(jout.skipped) == (call == bad_call)
        if call != bad_call:
            for name in ("loss", "grad_norm", "param_change_norm"):
                np.testing.assert_allclose(
                    getattr(pout, name).detach().numpy(),
                    np.asarray(getattr(jout, name)), **SCALAR,
                    err_msg=f"{name}, call {call}")
        assert int(opt["step"]) == int(jstate[2]["step"])
        _check_params(net, jstate)
        assert pstep.blocking_reads == 1
    assert int(opt["step"]) == 5
    assert seen == computed


def _snapshot(net, opt):
    """Copies of the network's state and of opt_state (new tensors)."""
    return ({k: v.clone() for k, v in net.state_dict().items()},
            {"velocity": {l: {k: v.clone() for k, v in p.items()}
                          for l, p in opt["velocity"].items()},
             "step": opt["step"].clone()})


def test_a_swapped_state_reseeds_the_step_count(monkeypatch):
    """A step that ran three calls is given the state (and parameters) of
    its 2nd: it reads the step count again, so the constraint falls on
    its 2nd call from there (the 4th non-skipped step), not its 1st, and
    its results equal an unbroken run's bit for bit."""
    _, _, pstep, net, np_batch, _ = _setup({})
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    scale = init_loss_scale(1.0, device="cpu")
    start = _snapshot(net, init_sgd_state(net.params))
    now, seen = _spy_constraint(monkeypatch)

    def run(state, calls):
        """`calls` calls from a copy of `state` (whose "step" the step
        never returned)."""
        net_state, opt = state
        net.load_state_dict(net_state)
        opt = dict(opt, step=opt["step"].clone())
        outs = []
        for call in range(1, calls + 1):
            now[0] = call
            opt, _, out = pstep(opt, scale, batch)
            outs.append(out)
        return outs, _snapshot(net, opt)

    unbroken, (unbroken_end, _) = run(start, 4)
    _, at2 = run(start, 2)
    run(at2, 1)                     # the step's count now reads 3
    reads = pstep.blocking_reads
    seen.clear()
    swapped, (end, opt) = run(at2, 2)
    assert pstep.blocking_reads == reads + 1
    assert seen == [2]
    assert int(opt["step"]) == 4
    for got, want in zip(swapped, unbroken[2:]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for k, v in end.items():
        assert torch.equal(v, unbroken_end[k]), k


@pytest.mark.parametrize("natural_gradient", [False, True])
def test_blocking_reads_count_the_calls_that_wait_on_their_own_flags(
        natural_gradient):
    """Without NG only the first call reads the device (the seed); with
    NG sites every call reads its own skip and the sites' counters."""
    cfg = dict(learning_rate=0.01, momentum=0.9,
               frame_subsampling_factor=STRIDE, left_context=LEFT,
               compute_dtype="float32", natural_gradient=natural_gradient,
               ng_rank_in=4, ng_rank_out=4)
    pm = build_model_from_string(XCONFIG)
    net = Network(pm, torch.Generator().manual_seed(0), "cpu")
    pden = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (T_OUT + 1),
                                  num_pdfs=P, T=T_OUT)) for _ in range(B)]
    pcfg = port_ts.TrainConfig(**cfg)
    pstep = port_ts.make_train_step(
        pm, net, pden, port_graph.build_numerator_batch(csrs),
        ChainTrainingOpts(), pcfg, num_frames_out=T_OUT)
    opt = init_sgd_state(net.params)
    if natural_gradient:
        opt["ng"] = port_ts.init_ng_states(pm, pcfg, "cpu")
    scale = init_loss_scale(1.0, device="cpu")
    batch = {"features": torch.from_numpy(
                 rng.normal(size=(B, T_IN, 8)).astype(np.float32)),
             "ivectors": torch.from_numpy(
                 rng.normal(size=(B, 10)).astype(np.float32))}
    assert pstep.blocking_reads == 0
    for call in range(1, 4):
        opt, scale, _ = pstep(opt, scale, batch)
        assert pstep.blocking_reads == (call if natural_gradient else 1)


_CARD = torch.device("cuda", 0)
_ELIGIBLE = dict(device=_CARD, ng=False, group=None,
                 config=port_ts.TrainConfig(), lr=None, spec_masks=None,
                 generator=None, batch_devices=(_CARD, _CARD))


@pytest.mark.parametrize("change", [
    {}, {"ng": True}, {"group": object()},
    {"config": port_ts.TrainConfig(remat=True)},
    {"config": port_ts.TrainConfig(use_loss_scaling=True)}, {"lr": 1e-3},
    {"spec_masks": {}}, {"device": torch.device("cpu")},
    {"batch_devices": (_CARD, torch.device("cpu"))},
    {"generator": torch.Generator()}], ids=[
    "eligible", "ng", "group", "remat", "loss_scaling", "lr", "spec_masks",
    "cpu", "batch_on_cpu", "cpu_generator"])
def test_graph_engagement_rule(change):
    """A call replays a graph only with its tensors on a card and nothing
    that reads a device value on the host, runs a collective or changes
    per call; each of these alone turns it off."""
    assert port_ts.graph_eligible(**dict(_ELIGIBLE, **change)) == (not change)


def test_cpu_steps_take_no_graph_and_are_unchanged():
    """On the CPU no call captures or replays a graph, and the steps'
    outputs, parameters and state equal those with graphs switched off,
    bit for bit."""
    runs = []
    for graphs in (True, False):
        _, _, pstep, net, np_batch, _ = _setup({})
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        opt = init_sgd_state(net.params)
        scale = init_loss_scale(1.0, device="cpu")
        saved, port_ts._GRAPHS = port_ts._GRAPHS, graphs
        try:
            outs = []
            for _ in range(5):
                opt, scale, out = pstep(opt, scale, batch)
                outs.append([t.clone() for t in out])
        finally:
            port_ts._GRAPHS = saved
        assert pstep.graph_captures == pstep.graph_replays == 0
        runs.append((outs, _snapshot(net, opt)))
    (outs_a, (net_a, opt_a)), (outs_b, (net_b, opt_b)) = runs
    for a, b in zip(outs_a, outs_b):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k, v in net_a.items():
        assert torch.equal(v, net_b[k]), k
    assert torch.equal(opt_a["step"], opt_b["step"])
    for l, p in opt_a["velocity"].items():
        for k, v in p.items():
            assert torch.equal(v, opt_b["velocity"][l][k]), (l, k)
