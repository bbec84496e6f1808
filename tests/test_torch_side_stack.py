"""The port's side stack against the JAX package, on the CPU: Adam
(training/schedulers.py), the generic NN ops (ops/nn.py), the losses
(ops/losses.py), the x-vector family (models/xvector.py) and profiling's
`trace` / `profile_fn` (utils/profiling.py).

Each case feeds numpy inputs from a seed through the JAX function and
its port:

* Adam: 10 steps with and without decoupled weight decay from one state
  (convert.adam_state_from_jax), rtol 1e-6 / atol 1e-7; the JAX test's
  quadratic (tests/test_ops_utils.py:153);
* the eight NN ops in fp32 at rtol 1e-5 / atol 1e-6: conv1d and
  avg / max pooling at strides 1 and 2, dilation 2, SAME and VALID, odd T;
  dropout by its properties (its masks come from a torch.Generator);
* cross_entropy in its four forms and weighted mse at rtol 1e-6;
* the x-vector forward (embedding and logits) and loss + gradients from
  converted weights, fp32 at 1e-5 and bf16 compute at 1e-2 of the
  output's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.models import xvector as jax_xv
from kaldi_fp16_tpu.ops import losses as jax_losses
from kaldi_fp16_tpu.ops import nn as jax_nn
from kaldi_fp16_tpu.training import schedulers as jax_sched
from kaldi_fp16_tpu_torch.convert import (
    adam_state_from_jax, adam_state_to_numpy, xvector_params_from_jax,
    xvector_params_to_numpy,
)
from kaldi_fp16_tpu_torch.models import xvector as port_xv
from kaldi_fp16_tpu_torch.ops import losses as port_losses
from kaldi_fp16_tpu_torch.ops import nn as port_nn
from kaldi_fp16_tpu_torch.training import schedulers as port_sched
from kaldi_fp16_tpu_torch.utils.profiling import profile_fn, trace

ADAM = dict(rtol=1e-6, atol=1e-7)
OPS = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-6)
XV_CFG = dict(feat_dim=12, tdnn_dims=(16, 16, 24),
              tdnn_contexts=((-2, -1, 0, 1, 2), (-2, 0, 2), (0,)),
              embed_dim=16, segment_dims=(16, 8), num_speakers=4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# -- Adam ---------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_ten_steps_match_jax(weight_decay):
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                    "b": rng.normal(size=3).astype(np.float32)},
              "c": rng.normal(size=7).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda w: rng.normal(size=w.shape).astype(np.float32), params)
        for _ in range(10)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_sched.init_adam_state(jp)
    pp = jax.tree_util.tree_map(lambda w: t(w.copy()), params)
    pstate = adam_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1) / 10
        jp, jstate = jax_sched.adam_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jstate, lr=lr,
            weight_decay=weight_decay)
        pp, pstate = port_sched.adam_update(
            pp, jax.tree_util.tree_map(t, g), pstate, lr=lr,
            weight_decay=weight_decay)
    got = flat(jax.tree_util.tree_map(lambda w: w.numpy(), pp))
    for k, v in flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        np.testing.assert_allclose(got[k], v, **ADAM, err_msg=k)
    ps = adam_state_to_numpy(pstate)
    js = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(ps["step"]) == int(js["step"]) == 10
    for part in ("m", "v"):
        for k, v in flat(js[part]).items():
            np.testing.assert_allclose(flat(ps[part])[k], v, **ADAM,
                                       err_msg=f"{part}/{k}")


def test_adam_writes_parameters_in_place_and_keeps_them_leaves():
    w = torch.nn.Parameter(torch.ones(3))
    params = {"w": w}
    params, state = port_sched.adam_update(
        params, {"w": torch.ones(3)}, port_sched.init_adam_state(params),
        lr=0.1)
    assert params["w"] is w and w.requires_grad and w.grad_fn is None
    assert float(w.detach()[0]) < 1.0
    assert state["step"].dtype == torch.int32


def test_adam_converges_quadratic():
    """tests/test_ops_utils.py:153 on the port."""
    params = {"w": torch.tensor([5.0, -3.0])}
    state = port_sched.init_adam_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw w^2
        params, state = port_sched.adam_update(params, grads, state, lr=0.1)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state["step"]) == 200


# -- NN ops ------------------------------------------------------------------

CONV_CASES = [(1, "SAME", 1), (2, "SAME", 1), (1, "VALID", 2),
              (2, "SAME", 2), (2, "VALID", 1), (1, "SAME", 2)]


@pytest.mark.parametrize("stride,padding,dilation", CONV_CASES)
@pytest.mark.parametrize("T", [13, 16])
def test_conv1d_matches_jax(stride, padding, dilation, T):
    rng = np.random.default_rng(T + stride)
    x = rng.normal(size=(2, T, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    ref = jax_nn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, padding=padding, dilation=dilation)
    got = port_nn.conv1d(t(x), t(w), t(b), stride=stride, padding=padding,
                         dilation=dilation)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


@pytest.mark.parametrize("op", ["max_pool1d", "avg_pool1d"])
@pytest.mark.parametrize("window,stride,padding",
                         [(2, None, "VALID"), (3, 1, "SAME"), (3, 2, "SAME"),
                          (2, 2, "SAME"), (4, 1, "VALID")])
@pytest.mark.parametrize("T", [11, 12])
def test_pooling_matches_jax(op, window, stride, padding, T):
    rng = np.random.default_rng(window * 10 + T)
    x = rng.normal(size=(2, T, 3)).astype(np.float32)
    ref = getattr(jax_nn, op)(jnp.asarray(x), window, stride, padding)
    got = getattr(port_nn, op)(t(x), window, stride, padding)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


@pytest.mark.parametrize("masked", [False, True])
def test_stats_pooling_matches_jax(masked):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 17, 5)).astype(np.float32)
    mask = (rng.uniform(size=(3, 17)) > 0.3) if masked else None
    ref = jax_nn.stats_pooling(jnp.asarray(x), mask=None if mask is None
                               else jnp.asarray(mask))
    got = port_nn.stats_pooling(t(x), mask=None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_matches_jax(affine):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32) if affine else None
    b = rng.normal(size=6).astype(np.float32) if affine else None
    ref = jax_nn.layer_norm(jnp.asarray(x), None if g is None else
                            jnp.asarray(g), None if b is None else
                            jnp.asarray(b))
    got = port_nn.layer_norm(t(x), None if g is None else t(g),
                             None if b is None else t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_depthwise_separable_conv1d_matches_jax(stride, padding):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 15, 4)).astype(np.float32)
    dw = rng.normal(size=(3, 1, 4)).astype(np.float32)
    pw = rng.normal(size=(1, 4, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    ref = jax_nn.depthwise_separable_conv1d(
        jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw), jnp.asarray(b),
        stride=stride, padding=padding)
    got = port_nn.depthwise_separable_conv1d(t(x), t(dw), t(pw), t(b),
                                             stride=stride, padding=padding)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


def test_squeeze_excite_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    w1, b1 = (rng.normal(size=(8, 3)).astype(np.float32),
              rng.normal(size=3).astype(np.float32))
    w2, b2 = (rng.normal(size=(3, 8)).astype(np.float32),
              rng.normal(size=8).astype(np.float32))
    ref = jax_nn.squeeze_excite(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    got = port_nn.squeeze_excite(*map(t, (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS)


def test_conv1d_bf16_input_keeps_its_dtype_with_an_fp32_product():
    rng = np.random.default_rng(5)
    x = t(rng.normal(size=(1, 9, 3)).astype(np.float32)).bfloat16()
    w = t(rng.normal(size=(3, 3, 2)).astype(np.float32)).bfloat16()
    ref = jax_nn.conv1d(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                        jnp.asarray(w.float().numpy(), jnp.bfloat16))
    got = port_nn.conv1d(x, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_dropout_properties():
    """Identity at train=False or rate 0; inverted scaling; the keep rate
    (JAX's properties: its masks come from another generator)."""
    x = torch.ones(64, 128)
    gen = torch.Generator().manual_seed(0)
    assert port_nn.dropout(x, 0.3, gen, train=False) is x
    assert port_nn.dropout(x, 0.0, gen) is x
    out = port_nn.dropout(x, 0.25, gen)
    kept = out != 0
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.75, rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    # a seeded generator repeats its mask; the JAX op keeps the same rate
    again = port_nn.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    jout = np.asarray(jax_nn.dropout(jnp.ones((64, 128)), 0.25,
                                     jax.random.PRNGKey(0)))
    assert abs(float((jout != 0).mean()) - 0.75) < 0.01


# -- losses ------------------------------------------------------------------

def _ce_inputs(form):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=6)
    kw = {}
    if form == "soft":
        soft = rng.uniform(size=(6, 5)).astype(np.float32)
        labels = soft / soft.sum(-1, keepdims=True)
    if form == "smoothing":
        kw["label_smoothing"] = 0.1
    if form == "weights":
        kw["weights"] = rng.uniform(size=6).astype(np.float32)
    return logits, labels, kw


@pytest.mark.parametrize("form", ["int", "soft", "smoothing", "weights"])
def test_cross_entropy_matches_jax(form):
    logits, labels, kw = _ce_inputs(form)
    ref = jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        **{k: (jnp.asarray(v) if k == "weights" else v)
           for k, v in kw.items()})
    got = port_losses.cross_entropy(
        t(logits), t(labels),
        **{k: (t(v) if k == "weights" else v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(ref), **LOSS)


def test_cross_entropy_zero_weights_hit_the_guard():
    logits, labels, _ = _ce_inputs("int")
    got = port_losses.cross_entropy(t(logits), t(labels),
                                    weights=torch.zeros(6))
    ref = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   weights=jnp.zeros(6))
    assert float(got) == float(ref) == 0.0


@pytest.mark.parametrize("shape,weighted", [((7,), False), ((4, 3, 2), False),
                                            ((4, 3, 2), True)])
def test_mse_matches_jax(shape, weighted):
    rng = np.random.default_rng(7)
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    w = rng.uniform(size=shape[0]).astype(np.float32) if weighted else None
    ref = jax_losses.mse(jnp.asarray(pred), jnp.asarray(target),
                         None if w is None else jnp.asarray(w))
    got = port_losses.mse(t(pred), t(target), None if w is None else t(w))
    np.testing.assert_allclose(float(got), float(ref), **LOSS)


# -- x-vector ----------------------------------------------------------------

def _xvector_case(seed=0, B=3, T=20):
    jcfg = jax_xv.XVectorConfig(**XV_CFG)
    pcfg = port_xv.XVectorConfig(**XV_CFG)
    jparams = jax_xv.init_xvector(jcfg, jax.random.PRNGKey(seed))
    pparams = xvector_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, XV_CFG["feat_dim"])).astype(np.float32)
    labels = rng.integers(0, XV_CFG["num_speakers"], size=B)
    return jcfg, pcfg, jparams, pparams, feats, labels


def test_xvector_config_defaults_match_jax():
    assert port_xv.XVectorConfig() == port_xv.XVectorConfig(
        **vars(jax_xv.XVectorConfig()))
    assert vars(port_xv.XVectorConfig()) == vars(jax_xv.XVectorConfig())


def test_init_xvector_tree_matches_jax_shapes():
    cfg = port_xv.XVectorConfig(**XV_CFG)
    p = port_xv.init_xvector(cfg, torch.Generator().manual_seed(0), "cpu")
    j = jax_xv.init_xvector(jax_xv.XVectorConfig(**XV_CFG),
                            jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in flat(xvector_params_to_numpy(p)).items()
            } == {k: v.shape for k, v in flat(
                jax.tree_util.tree_map(np.asarray, j)).items()}
    assert all(w.requires_grad for g in p.values() for w in g.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xvector_forward_matches_jax(dtype):
    jcfg, pcfg, jparams, pparams, feats, _ = _xvector_case()
    jemb, jlog = jax_xv.xvector_forward(jcfg, jparams, jnp.asarray(feats),
                                        compute_dtype=getattr(jnp, dtype))
    pemb, plog = port_xv.xvector_forward(pcfg, pparams, t(feats),
                                         compute_dtype=getattr(torch, dtype))
    for got, ref in ((pemb, jemb), (plog, jlog)):
        ref = np.asarray(ref)
        got = got.detach().numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    assert float(pemb.detach().min()) < 0     # segment0's pre-activation


def test_xvector_splice_clamps_at_the_edges():
    x = torch.arange(5, dtype=torch.float32).reshape(1, 5, 1)
    got = port_xv._splice(x, (-2, 0, 2))[0].numpy()
    ref = np.asarray(jax_xv._splice(jnp.asarray(x.numpy()), (-2, 0, 2))[0])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 0], [0, 0, 0, 1, 2])


def test_xvector_loss_and_grads_match_jax():
    jcfg, pcfg, jparams, pparams, feats, labels = _xvector_case(seed=1, B=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_xv.xvector_loss(jcfg, p, jnp.asarray(feats),
                                      jnp.asarray(labels)))(jparams)
    ploss = port_xv.xvector_loss(pcfg, pparams, t(feats), t(labels))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    got = flat({k: {n: w.grad.numpy() for n, w in g.items()}
                for k, g in pparams.items()})
    for k, v in flat(jax.tree_util.tree_map(np.asarray, jgrads)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


# -- profiling ---------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_events(tmp_path):
    a = torch.randn(32, 32)
    with trace(str(tmp_path / "tr"), device="cpu"):
        (a @ a).sum()
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in data["traceEvents"]}
    assert any("mm" in n for n in names)


def test_profile_fn_returns_the_jax_keys():
    stats = profile_fn(lambda x: (x * 2, {"y": x + 1}), torch.ones(16),
                       iters=3)
    assert set(stats) == {"mean_ms", "p50_ms", "min_ms"}
    assert 0 < stats["min_ms"] <= stats["p50_ms"]
    jstats = __import__("kaldi_fp16_tpu.utils.profiling",
                        fromlist=["profile_fn"]).profile_fn(
        jax.jit(lambda x: x * 2), jnp.ones(16), iters=2)
    assert set(jstats) == set(stats)
