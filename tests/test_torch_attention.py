"""The port's attention layer (attention-relu-batchnorm-layer, restricted
per-head time attention, models/network.py `_fwd_attention`) against the
JAX package's.

* The forward, from JAX weights loaded with `params_from_jax`, on
  narrow flagship-shaped models with one attention layer after the last
  TDNN-F: time-stride 3 (on the stride-3 grid, as in Kaldi's restricted
  attention recipes) and time-stride 1 (off the grid), train and eval,
  full rate and `time_subsample`; in fp32 at tests/test_torch_network.py's
  bars (rtol / atol 1e-4, the BN statistics too), in bf16 at atol 0.1
  with a mean error under 0.02.
* One SGD step and one NG-SGD step (the `attention1/w` site among the
  others) against the JAX step at tests/test_torch_train_step.py's bars:
  rtol 2e-4 / atol 2e-5 on the scalars, 1e-4 / 1e-5 on the parameters.
* The streaming encoder on an attention model against the JAX encoder
  (1e-4) and its own offline reference (2e-5, tests/test_streaming.py:92).
* Two gloo ranks against one process at tests/test_torch_parallel.py's
  bars: the attention layer's BatchNorm takes every rank's rows.
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import tests.test_torch_parallel as tpar
import tests.test_torch_streaming as tstr
import tests.test_torch_trainer as ttr
import tests.test_torch_train_step as tts
from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.decode import streaming as js
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.decode import streaming as ps
from kaldi_fp16_tpu_torch.models import network as port_net
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import (
    run_on_ranks, run_setup,
)
from tests.test_chain_numerator import random_fst
from tests.test_parallel import XCONFIG as PARALLEL_XCONFIG
from tests.test_streaming import XCONFIG as STREAM_XCONFIG
from tests.test_torch_network import NARROW

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_MEAN = 0.1, 0.02
B, T = 2, 30


def with_attention(xconfig, consumer, stride=3, heads=3, left=5, right=2):
    """`xconfig` with one attention layer inserted before the line
    `consumer`, which then takes the attention layer's output."""
    layer = (f"attention-relu-batchnorm-layer name=attention1 "
             f"num-heads={heads} value-dim=6 key-dim=4 "
             f"num-left-inputs={left} num-right-inputs={right} "
             f"time-stride={stride}")
    assert consumer in xconfig
    return xconfig.replace(consumer, layer + "\n" + re.sub(
        r"input=\S+", "input=attention1", consumer), 1)


PREFINAL = "prefinal-layer name=prefinal-l input=tdnnf4"
MODELS = {
    "stride3": with_attention(NARROW, PREFINAL),
    "stride1": with_attention(NARROW, PREFINAL, stride=1, heads=2,
                              left=2, right=1),
}


@pytest.fixture(scope="module", params=list(MODELS))
def nets(request):
    xconfig = MODELS[request.param]
    jm, pm = jax_build_from_string(xconfig), build_model_from_string(xconfig)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T, 8)).astype(np.float32)
    ivecs = rng.normal(size=(B, 10)).astype(np.float32)
    _, state = jax_net.forward(jm, params, state, jnp.asarray(feats),
                               jnp.asarray(ivecs), train=True,
                               compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    net.load_state_dict(params_from_jax(pm, params, state), strict=True)
    return request.param, jm, params, state, net, feats, ivecs


def test_model_and_init_match_jax(nets):
    which, jm, params, _, net, _, _ = nets
    pm = net.model
    assert pm.summary() == jm.summary()
    assert pm.time_context() == jm.time_context()
    for stride in (1, 3):
        assert port_net.grid_layers(pm, stride) == jax_net.grid_layers(jm,
                                                                       stride)
    assert ("attention1" in port_net.grid_layers(pm, 3)) == (which == "stride3")
    s = pm.layer_map["attention1"].spec
    own = port_net.Network(pm, torch.Generator().manual_seed(1), "cpu")
    w, b = (own.params["attention1"][k].detach() for k in ("w", "b"))
    assert tuple(w.shape) == params["attention1"]["w"].shape == (
        s.input_dim, s.num_heads * s.input_dim_per_head)
    assert not b.any() and b.shape == params["attention1"]["b"].shape
    # Xavier-normal: std sqrt(2 / (fan_in + fan_out))
    assert abs(float(w.std()) / np.sqrt(2.0 / sum(w.shape)) - 1) < 0.2


def run_both(nets, train, dtype, time_subsample=None):
    _, jm, params, state, net, feats, ivecs = nets
    jouts, jstate = jax_net.forward(
        jm, params, state, jnp.asarray(feats), jnp.asarray(ivecs),
        train=train, time_subsample=time_subsample,
        compute_dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    pouts, pstate = net(torch.from_numpy(feats), torch.from_numpy(ivecs),
                        train=train, compute_dtype=dtype,
                        time_subsample=time_subsample)
    return jouts, jstate, pouts, pstate


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("time_subsample", [None, (3, 1, 9)],
                         ids=["full-rate", "grid"])
def test_forward_fp32_matches_jax(nets, train, time_subsample):
    jouts, jstate, pouts, pstate = run_both(nets, train, torch.float32,
                                            time_subsample)
    n = T if time_subsample is None else time_subsample[2]
    for name in ("output", "output-xent"):
        assert pouts[name].shape == (B, n, 10)
        np.testing.assert_allclose(pouts[name].detach().numpy(),
                                   np.asarray(jouts[name]), **FP32,
                                   err_msg=name)
    fj = tts._flat(jax.tree_util.tree_map(np.asarray, jstate))
    fp = tts._flat(pstate)
    assert fj.keys() == fp.keys()
    for k in fj:
        np.testing.assert_allclose(fp[k], fj[k], **FP32, err_msg=k)


@pytest.mark.parametrize("time_subsample", [None, (3, 0, 10)],
                         ids=["full-rate", "grid"])
def test_forward_bf16_close_to_jax(nets, time_subsample):
    jouts, _, pouts, _ = run_both(nets, False, torch.bfloat16, time_subsample)
    for name in ("output", "output-xent"):
        p = pouts[name].detach().float().numpy()
        j = np.asarray(jouts[name], np.float32)
        np.testing.assert_allclose(p, j, rtol=0, atol=BF16_ATOL)
        assert np.abs(p - j).mean() < BF16_MEAN


TRAIN_XCONFIG = with_attention(tts.XCONFIG, PREFINAL)


def test_sgd_step_matches_jax(monkeypatch):
    monkeypatch.setattr(tts, "XCONFIG", TRAIN_XCONFIG)
    jout, pout, net = tts._run(1)
    assert not bool(pout.skipped) and bool(pout.ok)
    assert "attention1" in net.params


def test_ng_sgd_step_matches_jax():
    """One NG-SGD step (xent head, loss scaling, ranks 4) from the same JAX
    state: the scalars, every parameter and the NG states, the attention
    layer's site among them, as tests/test_torch_trainer.py holds them."""
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (ttr.T_OUT + 1),
                                  num_pdfs=tts.P, T=ttr.T_OUT))
            for _ in range(ttr.B)]
    batch = {"features": rng.normal(size=(ttr.B, ttr.T_IN, 8))
             .astype(np.float32),
             "ivectors": rng.normal(size=(ttr.B, 10)).astype(np.float32),
             "weights": np.array([1.0, 0.7, 0.9, 1.2], np.float32)}
    jm = jax_build_from_string(TRAIN_XCONFIG)
    jcfg = jax_ts.TrainConfig(**ttr.NG_CFG)
    jstep = jax_ts.make_train_step(
        jm, JaxDen(jax_graph.DenominatorGraph.from_fst(
            jax_graph.make_phone_lm_den_fst(**tts.DEN_KW), tts.P),
            leaky=1e-5),
        jax_graph.build_numerator_batch(csrs), JaxOpts(), jcfg,
        num_frames_out=ttr.T_OUT, donate=False)
    jstate = list(ttr.tree_np(ttr.jax_init_train_state(
        jm, jax.random.PRNGKey(0), jcfg)))
    assert "attention1/w" in jstate[2]["ng"]
    pair = {"pm": build_model_from_string(TRAIN_XCONFIG),
            "pden": DenominatorComputation(
                port_graph.DenominatorGraph.from_fst(
                    port_graph.make_phone_lm_den_fst(**tts.DEN_KW), tts.P),
                leaky=1e-5, device="cpu"),
            "num_graph": port_graph.build_numerator_batch(csrs)}
    net, pstep, opt, scale = ttr.port_from_jax(pair, jstate)
    *jstate, jout = jstep(*jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                          jax.random.PRNGKey(1))
    opt, scale, pout = pstep(opt, scale, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    ttr.assert_outputs_close(pout, jout)
    assert not bool(pout.skipped) and bool(pout.ok)
    ttr.assert_params_close(net, jstate[0], jstate[1])
    ttr.assert_ng_states_close(opt["ng"], ttr.tree_np(jstate[2]["ng"]))


STREAM_ATTENTION = with_attention(
    STREAM_XCONFIG, "prefinal-layer name=prefinal input=tdnnf2")


@pytest.fixture(scope="module")
def stream_nets():
    jm = jax_build_from_string(STREAM_ATTENTION)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(0))
    pm = build_model_from_string(STREAM_ATTENTION)
    net = port_net.Network(pm, torch.Generator(), device="cpu")
    net.load_state_dict(params_from_jax(pm, params, state), strict=True)
    return (jm, params, state), net


@pytest.mark.parametrize("chunk_out", [2, 4])
def test_streaming_encoder_matches_jax(stream_nets, chunk_out):
    (jm, params, state), net = stream_nets
    assert net.model.time_context() == jm.time_context() == (21, 12)
    enc = ps.StreamingEncoder(net, chunk_out=chunk_out,
                              compute_dtype=torch.float32, device="cpu")
    jenc = js.StreamingEncoder(jm, params, state, chunk_out=chunk_out,
                               compute_dtype=jnp.float32)
    assert (enc.W, enc.lag, enc.Wbuf) == (jenc.W, jenc.lag, jenc.Wbuf)
    x = np.random.default_rng(1).normal(
        size=(2, 12 * enc.subsample, 8)).astype(np.float32)
    got = tstr.run_encoder(enc, torch.from_numpy(x))
    assert got.shape[1] == 12
    ref = enc.offline_reference(
        torch.from_numpy(x), compute_dtype=enc.compute_dtype).float().numpy()
    np.testing.assert_allclose(got, ref, **tstr.FP32)
    np.testing.assert_allclose(got, tstr.run_encoder(jenc, jnp.asarray(x)),
                               **tstr.VS_JAX)


PARALLEL_ATTENTION = with_attention(
    PARALLEL_XCONFIG, "prefinal-layer name=prefinal small-dim=16 big-dim=32",
    stride=1, heads=2, left=2, right=1)


def test_two_ranks_equal_one_process():
    setup = tpar.make_setup(PARALLEL_ATTENTION)
    single = run_setup(setup, device="cpu")
    ranks = run_on_ranks([setup], 2, join_seconds=tpar.JOIN_SECONDS,
                         device="cpu")
    assert "layers.attention1.bn.mean" in single["params"]
    for got in ranks:
        tpar.assert_like_one_process(got[0], single)
