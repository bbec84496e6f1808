"""The fused den scans of the PyTorch port against the JAX package's.

The port's `DenominatorComputation(scan_impl="fused")` and the JAX one
(its Pallas scans run in interpret mode, as tests/test_pallas_den_scan.py
runs them) get the same numpy inputs.  Bars, those of
tests/test_pallas_den_scan.py:50-53 and :104-106: rtol 2e-5 on the
log-prob, rtol 2e-4 / atol 2e-6 on the posteriors (fp32 recursions over T
frames, summed in another order), and against the float64 oracle 5e-5
absolute on the log-prob and rtol 1e-3 / atol 5e-5 on the posteriors.

The raw histories of `fused_forward_plain` / `fused_backward_plain` are
held against the JAX kernels on the same emissions at rtol 2e-5 /
atol 1e-7 of the largest value: the JAX product is a 6-dot bf16 split
(~3e-7 relative per product), the port's an fp32 product, and the
difference compounds through the T-frame recursion.

The CUDA kernels themselves run only on a card: the `gpu` tests compare
them with the plain versions there.  JAX is imported inside the tests that
use it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_den_scan.py`.
"""

import functools

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import (
    analyze_chain_structure, pad_chains,
)
from kaldi_fp16_tpu_torch.chain.den_structured import (
    StructuredKernels, resolve_scan_impl,
)
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.chain.reference import (
    denominator_forward_backward_ref,
)
from kaldi_fp16_tpu_torch.ops import den_scan
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul, split_planes

LOGP_RTOL = 2e-5
POST_RTOL, POST_ATOL = 2e-4, 2e-6
ORACLE_LOGP_ATOL, ORACLE_POST_RTOL, ORACLE_POST_ATOL = 5e-5, 1e-3, 5e-5
HIST_RTOL, HIST_ATOL_REL = 2e-5, 1e-7
GRAPHS = {
    "L2": (24, 13, 2, 4, 3),          # num_pdfs, phones, states, branching, seed
    "L2-seed7": (24, 13, 2, 4, 7),
    "L3": (30, 8, 3, 3, 7),
}


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's DenominatorComputation with its Pallas scans
    interpreted."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    import kaldi_fp16_tpu.ops.pallas_den_scan as mod
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as J
    return J


def _graph(key):
    P, phones, states, branching, seed = GRAPHS[key]
    return DenominatorGraph.from_fst(
        make_phone_lm_den_fst(P, phones, states, branching, seed=seed), P)


def _nnet(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("key,T", [("L2", 7), ("L2-seed7", 5), ("L3", 6)])
def test_fused_den_matches_jax_fused_and_fp64(jax_fused, key, T):
    import jax.numpy as jnp
    g = _graph(key)
    x = _nnet((128, T, g.num_pdfs), seed=T)
    den = DenominatorComputation(g, leaky=1e-4, scan_impl="fused",
                                 device="cpu")
    assert den._structured._use_fused(128, True)
    lp, post = den.forward_backward(torch.from_numpy(x))
    assert den._structured.scan_used == "fused"
    jlp, jpost = jax_fused(g, leaky=1e-4, scan_impl="fused") \
        .forward_backward(jnp.asarray(x))
    # both sides against the float64 oracle on every row first, so that a
    # torch-vs-JAX failure says which side lies off the oracle
    ref_lp = np.array([denominator_forward_backward_ref(g, x[n],
                                                        leaky=1e-4)[0]
                       for n in range(x.shape[0])])
    off = {side: np.abs(np.asarray(v, np.float64) - ref_lp)
           for side, v in (("torch", lp.numpy()), ("jax", np.asarray(jlp)))}
    report = "; ".join(
        f"{side}: {int((e >= ORACLE_LOGP_ATOL).sum())} of {len(e)} rows "
        f"off the float64 log-prob by >= {ORACLE_LOGP_ATOL}, worst "
        f"{e.max():.3g} at row {int(e.argmax())}" for side, e in off.items())
    assert off["torch"].max() < ORACLE_LOGP_ATOL, report
    assert off["jax"].max() < ORACLE_LOGP_ATOL, report
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=LOGP_RTOL,
                               err_msg=report)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost),
                               rtol=POST_RTOL, atol=POST_ATOL)
    for n in (0, 77):
        rlp, rpost = denominator_forward_backward_ref(g, x[n], leaky=1e-4)
        assert abs(float(lp[n]) - rlp) < ORACLE_LOGP_ATOL
        np.testing.assert_allclose(post[n].numpy(), rpost,
                                   rtol=ORACLE_POST_RTOL,
                                   atol=ORACLE_POST_ATOL)


def test_fused_forward_only_matches_jax(jax_fused):
    import jax.numpy as jnp
    g = _graph("L2")
    x = _nnet((128, 5, g.num_pdfs), seed=1)
    lp = DenominatorComputation(g, leaky=1e-4, scan_impl="fused",
                                device="cpu").forward(
        torch.from_numpy(x))
    jlp = jax_fused(g, leaky=1e-4, scan_impl="fused").forward(
        jnp.asarray(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=LOGP_RTOL)


def _tables(key, T, seed):
    """The fused path's padded layout and its hoisted emission tables."""
    g = _graph(key)
    sk = StructuredKernels(analyze_chain_structure(g), 1e-4,
                           scan_impl="fused", device="cpu")
    x = torch.from_numpy(_nnet((T, g.num_pdfs, 128), seed)).clamp(-30, 30)
    return sk, sk._hoisted_emissions(torch.exp(x))


@pytest.mark.parametrize("key", ["L2", "L3"])
def test_plain_scans_match_jax_kernels(key):
    """Raw histories: port plain versions vs the JAX Pallas kernels."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from kaldi_fp16_tpu.ops.pallas_den_scan import (
        fused_backward, fused_forward, split3_matrix,
    )
    from kaldi_fp16_tpu.ops import pallas_den_scan as mod
    from jax.experimental import pallas as pl
    T, leaky = 6, 1e-4
    sk, (xs_self, xs_fwd, xs_res) = _tables(key, T, seed=4)
    L, M, init = sk.lay.L, sk.M, sk.init
    hist, asum, logc, a_fin = den_scan.fused_forward_plain(
        M.t(), xs_self, xs_fwd, xs_res, init, L=L, T=T, leaky=leaky)
    total = a_fin * (1.0 + leaky * sk._init_sum)
    beta = den_scan.fused_backward_plain(
        M, xs_self, xs_fwd, xs_res, asum, init, sk.real, total,
        L=L, T=T, leaky=leaky)

    j = {k: jnp.asarray(v.numpy()) for k, v in (
        ("xs_self", xs_self), ("xs_fwd", xs_fwd), ("xs_res", xs_res),
        ("init", init))}
    orig = mod.pl.pallas_call
    mod.pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    try:
        jhist, stats, jfin = fused_forward(
            split3_matrix(M.t().contiguous().numpy()), j["xs_self"],
            j["xs_fwd"], j["xs_res"], j["init"], L=L, T=T, leaky=leaky,
            terms=6)
        # the TPU layout: stats [T, 8, N] rows 0/1, a_final / total [8, N]
        jtotal = jfin[0] * (1.0 + leaky * sk._init_sum)
        jbeta = fused_backward(
            split3_matrix(M.numpy()), j["xs_self"], j["xs_fwd"],
            j["xs_res"], stats, j["init"],
            jnp.asarray(sk.real.numpy().astype(np.float32)),
            jnp.zeros((8, 128), jnp.float32).at[0].set(jtotal),
            L=L, T=T, leaky=leaky, terms=6)
    finally:
        mod.pl.pallas_call = orig
    stats = np.asarray(stats)
    for name, ours, ref in (("adash_hist", hist, jhist),
                            ("asum", asum, stats[:, 0]),
                            ("logc", logc, stats[:, 1]),
                            ("a_final", a_fin, np.asarray(jfin)[0]),
                            ("beta_hist", beta, jbeta)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            ours.numpy(), ref, rtol=HIST_RTOL,
            atol=HIST_ATOL_REL * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("key", ["L2", "L3"])
@pytest.mark.parametrize("leaky", [1e-4, 1e-5])
def test_fused_matches_loop_in_the_port(key, leaky):
    g = _graph(key)
    x = torch.from_numpy(_nnet((128, 6, g.num_pdfs), seed=9))
    lp_f, post_f = DenominatorComputation(
        g, leaky=leaky, scan_impl="fused", device="cpu").forward_backward(x)
    loop = DenominatorComputation(g, leaky=leaky, scan_impl="loop",
                                  device="cpu")
    lp_l, post_l = loop.forward_backward(x)
    assert loop._structured.scan_used == "loop"
    torch.testing.assert_close(lp_f, lp_l, rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post_f, post_l, rtol=POST_RTOL,
                               atol=POST_ATOL)


def test_odd_batch_takes_the_loop_path_and_launches_nothing():
    """The counterpart of test_odd_batch_falls_back: N = 3 is no lane
    multiple, so the fused instance runs its loop path (on the padded
    layout) and matches a loop instance."""
    g = _graph("L2")
    den = DenominatorComputation(g, leaky=1e-4, scan_impl="fused",
                                 device="cpu")
    assert not den._structured._use_fused(3, True)
    before = (den_scan.fused_forward.launches,
              den_scan.fused_backward.launches, DenMatmul.launches)
    x = torch.from_numpy(_nnet((3, 5, g.num_pdfs), seed=2))
    lp, post = den.forward_backward(x)
    assert den._structured.scan_used == "loop"
    assert (den_scan.fused_forward.launches,
            den_scan.fused_backward.launches, DenMatmul.launches) == before
    lp_l, post_l = DenominatorComputation(
        g, leaky=1e-4, device="cpu").forward_backward(x)
    torch.testing.assert_close(lp, lp_l, rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post, post_l, rtol=POST_RTOL, atol=POST_ATOL)


def test_scan_impl_options_and_padding():
    g = _graph("L2")
    auto = DenominatorComputation(g, scan_impl="auto",
                                  device="cpu")._structured
    assert auto.scan_impl == "loop" and not auto._fused_ready
    assert auto.lay.F == 13                    # loop path stays unpadded
    fused = DenominatorComputation(g, scan_impl="fused",
                                   device="cpu")._structured
    assert fused._fused_ready and fused.lay.F == 128
    assert den_scan.fused_scan_supported(fused.lay, 128)
    assert not den_scan.fused_scan_supported(fused.lay, 64)
    assert not den_scan.fused_scan_supported(auto.lay, 128)
    with pytest.raises(ValueError):
        DenominatorComputation(g, scan_impl="xla", device="cpu")
    # a one-state-per-phone graph (L = 1) is never fused
    one = DenominatorGraph.from_fst(make_phone_lm_den_fst(16, 9, 1, 3,
                                                          seed=5), 16)
    assert not DenominatorComputation(
        one, scan_impl="fused", device="cpu")._structured._fused_ready


@pytest.mark.parametrize("device,want", [("cpu", "loop"), ("cuda", "fused"),
                                         (torch.device("cuda", 0), "fused")])
def test_auto_scan_resolves_to_fused_on_a_card(device, want):
    assert resolve_scan_impl("auto", device) == want
    for explicit in ("loop", "fused"):
        assert resolve_scan_impl(explicit, device) == explicit


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    T = 4
    sk, (xs_self, xs_fwd, xs_res) = _tables("L2", T, seed=3)
    L, M, init = sk.lay.L, sk.M, sk.init
    before = (den_scan.fused_forward.launches,
              den_scan.fused_backward.launches)
    out = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init, L=L, T=T,
                                 leaky=1e-5)
    ref = den_scan.fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                       L=L, T=T, leaky=1e-5)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    total = torch.ones(128)
    beta = den_scan.fused_backward(M, xs_self, xs_fwd, xs_res, out[1], init,
                                   sk.real, total, L=L, T=T, leaky=1e-5)
    assert torch.equal(beta, den_scan.fused_backward_plain(
        M, xs_self, xs_fwd, xs_res, out[1], init, sk.real, total,
        L=L, T=T, leaky=1e-5))
    assert (den_scan.fused_forward.launches,
            den_scan.fused_backward.launches) == before
    with pytest.raises(ValueError):              # xs_fwd has L-1 rows
        den_scan.fused_forward(M, xs_self, xs_self, xs_res, init, L=L, T=T,
                               leaky=1e-5)
    with pytest.raises(TypeError):
        den_scan.fused_forward(M.double(), xs_self, xs_fwd, xs_res, init,
                               L=L, T=T, leaky=1e-5)


SMALL_XCONFIG = """
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-batchnorm, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf4 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim=24
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim=24
"""


def test_train_step_with_the_fused_den_matches_the_loop_den():
    """One fp32 train step of the narrow flagship-shaped model at N = 128:
    the fused den and the loop den give the same loss and grad norm
    within 2e-5 relative (the den posterior bar, diluted by the rest of
    the step)."""
    from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch, LOG_ZERO
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )
    B, T_IN, LEFT, STRIDE, P = 128, 15, 3, 3, 24
    t_out = (T_IN - LEFT + STRIDE - 1) // STRIDE
    rng = np.random.default_rng(5)
    arcs = np.arange(2 * t_out, dtype=np.int32) % t_out
    Sn = t_out + 1
    num_graph = NumeratorGraphBatch(
        arc_src=np.tile(arcs, (B, 1)), arc_dst=np.tile(arcs + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, 2 * t_out)).astype(np.int32),
        arc_logw=np.zeros((B, 2 * t_out), np.float32),
        arc_mask=np.ones((B, 2 * t_out), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=2 * t_out)
    batch = {"features": torch.from_numpy(
                 rng.normal(size=(B, T_IN, 8)).astype(np.float32)),
             "ivectors": torch.from_numpy(
                 rng.normal(size=(B, 10)).astype(np.float32))}
    model = build_model_from_string(SMALL_XCONFIG)
    g = _graph("L2")
    config = TrainConfig(learning_rate=0.01, momentum=0.9,
                         frame_subsampling_factor=STRIDE, left_context=LEFT,
                         compute_dtype="float32")
    outs = {}
    for scan in ("fused", "loop"):
        den = DenominatorComputation(g, leaky=1e-5, scan_impl=scan,
                                     device="cpu")
        net, opt, scale = init_train_state(
            model, torch.Generator().manual_seed(0), config, device="cpu")
        step = make_train_step(model, net, den, num_graph,
                               ChainTrainingOpts(), config,
                               num_frames_out=t_out)
        _, _, outs[scan] = step(opt, scale, batch)
        assert den._structured.scan_used == scan
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(getattr(outs["fused"], name)),
                                   float(getattr(outs["loop"], name)),
                                   rtol=2e-5, err_msg=name)
    assert bool(outs["fused"].ok) and not bool(outs["fused"].skipped)


@pytest.mark.gpu
@pytest.mark.parametrize("key,T", [("L2", 7), ("L3", 5)])
def test_cuda_scans_against_plain(key, T):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the den_scan kernels are CUDA only")
    dev = torch.device("cuda")
    sk, tables = _tables(key, T, seed=6)
    xs_self, xs_fwd, xs_res = (t.to(dev) for t in tables)
    M, init, real = sk.M.to(dev), sk.init.to(dev), sk.real.to(dev)
    L, leaky = sk.lay.L, 1e-4
    kw = dict(L=L, T=T, leaky=leaky)
    ref = den_scan.fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                       **kw)
    # split="kernel" (the fp32 M) and split="pre" (its bf16 planes)
    for planes in (None, split_planes(M, M.shape[0])):
        before = den_scan.fused_forward.launches
        out = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                     planes=planes, **kw)
        again = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                       planes=planes, **kw)
        torch.cuda.synchronize()
        assert den_scan.fused_forward.launches == before + 2
        for a, b, r in zip(out, again, ref):
            assert torch.equal(a, b)                 # fixed-order sums
            torch.testing.assert_close(a, r, rtol=HIST_RTOL,
                                       atol=HIST_ATOL_REL * float(r.abs().max()))
        total = out[3] * (1.0 + leaky * sk._init_sum)
        beta = den_scan.fused_backward(M, xs_self, xs_fwd, xs_res, out[1],
                                       init, real, total, planes=planes, **kw)
        beta_again = den_scan.fused_backward(M, xs_self, xs_fwd, xs_res,
                                             out[1], init, real, total,
                                             planes=planes, **kw)
        beta_ref = den_scan.fused_backward_plain(M, xs_self, xs_fwd, xs_res,
                                                 out[1], init, real, total,
                                                 **kw)
        assert torch.equal(beta, beta_again)
        torch.testing.assert_close(
            beta, beta_ref, rtol=HIST_RTOL,
            atol=HIST_ATOL_REL * float(beta_ref.abs().max()))
