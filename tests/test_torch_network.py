"""The PyTorch port's network against the JAX package.

JAX `init_params` makes the parameters; `params_from_jax` loads them into
the port; both forwards run on the same numpy features.  The xconfig is
flagship-shaped at narrow widths: idct, batchnorm, spec-augment, the
ivector linear (ReplaceIndex), combine-feature-maps, two convs (one
height-subsampled), tdnnf at time-strides 0 and 3, prefinal and both heads.

Tolerances: in fp32 the two frameworks differ only in the summation order
of matmuls, convs and the BN statistics, amplified through a dozen
batchnorms: rtol 1e-4 / atol 1e-4.  In bf16 they also round at different
places (torch rounds each matmul's output to bf16, JAX keeps it fp32 until
the bias add), a few bf16 ulps (2^-8 relative each) through the stack:
atol 0.1 on outputs of magnitude ~1, and a mean error under 0.02.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model as jax_build_model,
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu_torch.convert import params_from_jax, params_to_numpy
from kaldi_fp16_tpu_torch.models import network as port_net
from kaldi_fp16_tpu_torch.models.model import (
    build_model, build_model_from_string,
)

FP32 = dict(rtol=1e-4, atol=1e-4)
FLAGSHIP = "configs/cnn_tdnn.xconfig"
NARROW = """
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
spec-augment-layer name=idct-spec-augment input=idct-batchnorm freq-max-proportion=0.5 time-zeroed-proportion=0.2 time-mask-max-frames=4
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-spec-augment, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf4 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim=10
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim=10
"""
B, T = 2, 15


def _both_models(which):
    if which == "flagship":
        return jax_build_model(FLAGSHIP), build_model(FLAGSHIP)
    return jax_build_from_string(NARROW), build_model_from_string(NARROW)


@pytest.mark.parametrize("which", ["flagship", "narrow"])
def test_model_copies_equal_the_originals(which):
    jm, pm = _both_models(which)
    assert jm.summary() == pm.summary()
    assert jm.num_params() == pm.num_params()
    assert jm.time_context() == pm.time_context()
    for jl, pl in zip(jm.execution_order(), pm.execution_order()):
        assert (jl.name, jl.type.value, jl.input_dim, jl.output_dim,
                jl.input.names) == (pl.name, pl.type.value, pl.input_dim,
                                    pl.output_dim, pl.input.names)
        assert type(jl.spec).__name__ == type(pl.spec).__name__
        # the port's specs may carry options the JAX package has not (the
        # output layer's output-delay): those stand at their defaults here
        js, ps = dataclasses.asdict(jl.spec), dataclasses.asdict(pl.spec)
        assert js == {k: ps[k] for k in js}
        defaults = {f.name: f.default for f in dataclasses.fields(pl.spec)}
        assert all(ps[k] == defaults[k] for k in ps if k not in js)
    assert jm.chain_output().name == pm.chain_output().name
    assert jm.xent_output().name == pm.xent_output().name
    for stride in (1, 3):
        assert jax_net.grid_layers(jm, stride) == port_net.grid_layers(pm, stride)
        assert (jax_net.conv_cut_layers(jm, stride)
                == port_net.conv_cut_layers(pm, stride))


@pytest.fixture(scope="module")
def nets():
    jm, pm = _both_models("narrow")
    params, _ = jax_net.init_params(jm, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T, 8)).astype(np.float32)
    ivecs = rng.normal(size=(B, 10)).astype(np.float32)
    # non-trivial running statistics: one training forward's
    _, state = jax_net.forward(
        jm, params, jax_net.init_params(jm, jax.random.PRNGKey(0))[1],
        jnp.asarray(feats), jnp.asarray(ivecs), train=True,
        compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    net = port_net.Network(pm, torch.Generator().manual_seed(0), "cpu")
    net.load_state_dict(params_from_jax(pm, params, state), strict=True)
    return jm, params, state, net, feats, ivecs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_params_round_trip_and_own_init_shapes(nets):
    jm, params, state, net, _, _ = nets
    p2, s2 = params_to_numpy(net)
    fp, fp2 = _flat(params), _flat(p2)
    assert fp.keys() == fp2.keys()
    for k in fp:
        np.testing.assert_array_equal(fp[k], fp2[k], err_msg=k)
    for k, v in _flat(state).items():
        np.testing.assert_array_equal(v, _flat(s2)[k], err_msg=k)
    # the port's own initialisation has the JAX package's tree and shapes
    own, _ = params_to_numpy(port_net.Network(
        net.model, torch.Generator().manual_seed(1), "cpu"))
    fo = _flat(own)
    assert {k: v.shape for k, v in fo.items()} == \
        {k: v.shape for k, v in fp.items()}
    np.testing.assert_array_equal(fo["idct/idct"], fp["idct/idct"])


def _run(nets, *, train, dtype, time_subsample=None, masks=None,
         monkeypatch=None):
    jm, params, state, net, feats, ivecs = nets
    rng = None
    if masks is not None:
        # JAX's PRNG stream cannot be replayed in torch: give both the same
        # numpy masks
        f_keep, t_keep = masks

        def fixed_masks(spec, x, _rng):
            x = x * jnp.asarray(f_keep)[:, None, :].astype(x.dtype)
            return x * jnp.asarray(t_keep)[:, :, None].astype(x.dtype)

        monkeypatch.setattr(jax_net, "_fwd_spec_augment", fixed_masks)
        rng = jax.random.PRNGKey(3)
    jouts, jstate = jax_net.forward(
        jm, params, state, jnp.asarray(feats), jnp.asarray(ivecs),
        train=train, rng=rng,
        compute_dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16,
        time_subsample=time_subsample)
    spec_masks = None
    if masks is not None:
        spec_masks = {"idct-spec-augment": tuple(torch.from_numpy(m)
                                                 for m in masks)}
    pouts, pstate = net(torch.from_numpy(feats), torch.from_numpy(ivecs),
                        train=train, compute_dtype=dtype,
                        time_subsample=time_subsample, spec_masks=spec_masks)
    return jouts, jstate, pouts, pstate


def _check_state(jstate, pstate):
    fj = _flat(jax.tree_util.tree_map(np.asarray, jstate))
    fp = _flat(pstate)
    assert fj.keys() == fp.keys()
    for k in fj:
        np.testing.assert_allclose(fp[k].astype(np.float32), fj[k],
                                   **FP32, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("time_subsample", [None, (3, 1, 5)],
                         ids=["full-rate", "grid-cut-conv"])
def test_forward_fp32_matches_jax(nets, train, time_subsample):
    jouts, jstate, pouts, pstate = _run(
        nets, train=train, dtype=torch.float32,
        time_subsample=time_subsample)
    n_frames = T if time_subsample is None else time_subsample[2]
    for name in ("output", "output-xent"):
        assert pouts[name].shape == (B, n_frames, 10)
        assert pouts[name].dtype == torch.float32
        np.testing.assert_allclose(pouts[name].detach().numpy(),
                                   np.asarray(jouts[name]), **FP32,
                                   err_msg=name)
    _check_state(jstate, pstate)


def test_forward_spec_augment_masks_injected(nets, monkeypatch):
    rng = np.random.default_rng(9)
    f_keep = rng.random((B, 8)) > 0.3
    t_keep = rng.random((B, T)) > 0.2
    jouts, jstate, pouts, pstate = _run(
        nets, train=True, dtype=torch.float32, masks=(f_keep, t_keep),
        monkeypatch=monkeypatch)
    for name in ("output", "output-xent"):
        np.testing.assert_allclose(pouts[name].detach().numpy(),
                                   np.asarray(jouts[name]), **FP32)
    _check_state(jstate, pstate)


def test_spec_augment_masks_from_a_generator():
    pm = build_model_from_string(NARROW)
    spec = pm.layer_map["idct-spec-augment"].spec
    g = torch.Generator().manual_seed(4)
    f_keep, t_keep = port_net.spec_augment_masks(spec, 64, 40, g, "cpu")
    assert f_keep.shape == (64, 8) and t_keep.shape == (64, 40)
    # the band is at most freq_max_proportion * D wide
    assert ((~f_keep).sum(1) <= int(0.5 * 8)).all()
    assert (~t_keep).any() and t_keep.any()
    again = port_net.spec_augment_masks(spec, 64, 40,
                                        torch.Generator().manual_seed(4),
                                        "cpu")
    assert torch.equal(again[0], f_keep) and torch.equal(again[1], t_keep)


@pytest.mark.parametrize("time_subsample", [None, (3, 0, 5)],
                         ids=["full-rate", "grid-cut-conv"])
def test_forward_bf16_close_to_jax(nets, time_subsample):
    jouts, _, pouts, _ = _run(nets, train=False, dtype=torch.bfloat16,
                              time_subsample=time_subsample)
    for name in ("output", "output-xent"):
        p = pouts[name].detach().float().numpy()
        j = np.asarray(jouts[name], np.float32)
        np.testing.assert_allclose(p, j, rtol=0, atol=0.1)
        assert np.abs(p - j).mean() < 0.02


# the low-precision BatchNorm (set_bn_lowp_stats): the same arithmetic in
# both frameworks, bf16 elementwise ops that round each result and
# fp32-accumulated means summed in another order; so a bf16 output within
# one bf16 ulp (2^-8 of its magnitude, atol at the largest), the fp32
# statistics at fp32 summation noise
LOWP_STATE = dict(rtol=1e-5, atol=1e-6)


def _lowp_inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ill":        # |mean| >> std: the two-pass variance's case
        x = (100.0 + 0.1 * rng.normal(size=(4, 10, 8))).astype(np.float32)
    else:
        x = rng.normal(loc=1.0, scale=2.0, size=(4, 10, 8)).astype(np.float32)
    st = {"count": np.float32(40.0), "mean": np.full(8, 0.5, np.float32),
          "var": np.full(8, 2.0, np.float32)}
    return x, st


@pytest.mark.parametrize("kind,dtype,train", [
    ("normal", "bfloat16", True), ("normal", "bfloat16", False),
    ("ill", "bfloat16", True), ("ill", "float32", True)])
def test_batchnorm_lowp_matches_jax(kind, dtype, train):
    x, st = _lowp_inputs(kind)
    jout, jst = jax_net._batchnorm_lowp(
        jnp.asarray(x).astype(getattr(jnp, dtype)),
        {k: jnp.asarray(v) for k, v in st.items()}, 1.0, 1e-3, train)
    out, pst = port_net._batchnorm_lowp(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        {k: torch.as_tensor(v) for k, v in st.items()}, 1.0, 1e-3, train)
    assert out.dtype == getattr(torch, dtype)
    j = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), j, rtol=0,
                               atol=2.0 ** -8 * np.abs(j).max())
    for k in ("count", "mean", "var"):
        np.testing.assert_allclose(np.asarray(pst[k], np.float32),
                                   np.asarray(jst[k]), **LOWP_STATE,
                                   err_msg=k)


def test_batchnorm_lowp_gradient_matches_jax():
    """The input gradient of a weighted sum of the bf16 output: autograd
    through the same bf16 ops in both, whose backward reductions round to
    bf16 in another order: within a bf16 ulp of the largest entry (2^-7
    of it), and 2^-8 of it on average."""
    x, st = _lowp_inputs("normal", seed=3)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(xb):
        out, _ = jax_net._batchnorm_lowp(
            xb, {k: jnp.asarray(v) for k, v in st.items()}, 1.0, 1e-3, True)
        return jnp.sum(out.astype(jnp.float32) * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x).astype(jnp.bfloat16)),
                    np.float32)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    out, _ = port_net._batchnorm_lowp(
        xb, {k: torch.as_tensor(v) for k, v in st.items()}, 1.0, 1e-3, True)
    (out.float() * torch.from_numpy(w)).sum().backward()
    g = xb.grad.float().numpy()
    np.testing.assert_allclose(g, jg, rtol=0, atol=2.0 ** -7 * np.abs(jg).max())
    assert np.abs(g - jg).mean() < 2.0 ** -8 * np.abs(jg).max()


def test_bn_lowp_switch_routes_bf16_only():
    """As the JAX module's switch: bf16 inputs take the low-precision
    BatchNorm, fp32 ones the exact path; lowp= overrides the switch."""
    x, st = _lowp_inputs("normal")
    state = {k: torch.as_tensor(v) for k, v in st.items()}
    x16, x32 = torch.from_numpy(x).bfloat16(), torch.from_numpy(x)
    low = port_net._batchnorm_lowp(x16, state, 1.0, 1e-3, True)[0]
    exact16 = port_net._batchnorm(x16, state, 1.0, 1e-3, True)[0]
    exact32 = port_net._batchnorm(x32, state, 1.0, 1e-3, True)[0]
    assert not torch.equal(low, exact16)
    port_net.set_bn_lowp_stats(True)
    try:
        assert torch.equal(port_net._batchnorm(x16, state, 1.0, 1e-3,
                                               True)[0], low)
        assert torch.equal(port_net._batchnorm(x32, state, 1.0, 1e-3,
                                               True)[0], exact32)
        assert torch.equal(port_net._batchnorm(x16, state, 1.0, 1e-3, True,
                                               lowp=False)[0], exact16)
    finally:
        port_net.set_bn_lowp_stats(False)
    assert torch.equal(port_net._batchnorm(x16, state, 1.0, 1e-3, True,
                                           lowp=True)[0], low)


@pytest.mark.parametrize("train", [False, True])
def test_forward_bf16_with_bn_lowp_close_to_jax(nets, train):
    """The narrow network in bf16 with the switch on in both packages, at
    the bf16 bars of test_forward_bf16_close_to_jax."""
    jax_net.set_bn_lowp_stats(True)
    port_net.set_bn_lowp_stats(True)
    try:
        jouts, jstate, pouts, pstate = _run(nets, train=train,
                                            dtype=torch.bfloat16)
    finally:
        jax_net.set_bn_lowp_stats(False)
        port_net.set_bn_lowp_stats(False)
    for name in ("output", "output-xent"):
        p = pouts[name].detach().float().numpy()
        j = np.asarray(jouts[name], np.float32)
        np.testing.assert_allclose(p, j, rtol=0, atol=0.1)
        assert np.abs(p - j).mean() < 0.02
    if train:
        fj = _flat(jax.tree_util.tree_map(np.asarray, jstate))
        fp = _flat(pstate)
        for k in fj:
            np.testing.assert_allclose(fp[k].astype(np.float32), fj[k],
                                       rtol=0.02, atol=0.02, err_msg=k)


def test_forward_reads_the_bn_switch_once(nets, monkeypatch):
    """A switch turned off while a forward runs does not reach it: every
    BatchNorm of that forward stays low-precision, as the JAX switch,
    read at trace time, does."""
    _, _, _, net, feats, ivecs = nets
    calls = []
    lowp = port_net._batchnorm_lowp

    def turn_off_after_first(*a, **kw):
        calls.append(1)
        port_net.set_bn_lowp_stats(False)
        return lowp(*a, **kw)

    monkeypatch.setattr(port_net, "_batchnorm_lowp", turn_off_after_first)
    port_net.set_bn_lowp_stats(True)
    try:
        net(torch.from_numpy(feats), torch.from_numpy(ivecs), train=True,
            compute_dtype=torch.bfloat16)
    finally:
        port_net.set_bn_lowp_stats(False)
    assert len(calls) == len(_flat(net.bn_state())) // 3 > 1
