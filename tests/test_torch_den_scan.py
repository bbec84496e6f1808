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


# single bf16 passes on two sides: an fp32 operand one ulp apart on the
# two sides (another summation order upstream) rounds to the other bf16
# neighbour where it lies at a rounding tie, moving that product by up to
# one bf16 ulp, 2^-7 relative.  So the fast dens meet the exact bars
# except at such ties: at most TIE_FRACTION of the elements, each within
# TIE_RTOL.
TIE_RTOL, TIE_FRACTION = 2.0 ** -7, 1e-3


def bf16_fp64(a):
    """float64 values as the port rounds its fp32 ones for a single bf16
    pass: to float32, then to bf16 (nearest even), back to float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def assert_close_but_ties(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    assert off.mean() <= TIE_FRACTION, (int(off.sum()), off.size)
    np.testing.assert_allclose(got, want, rtol=TIE_RTOL, atol=atol)


@pytest.fixture
def tpu_arithmetic(monkeypatch):
    """jnp.matmul and jnp.einsum as a TPU computes a default-precision
    product of a bf16 operand with an fp32 one: both operands rounded to
    bf16.  On the CPU, XLA promotes the bf16 operand to fp32 instead and
    rounds nothing of the fp32 one (ROADMAP.md queue 3), which moves the
    JAX fast den's bulk posteriors off the TPU's numbers by ~5e-3.  The
    JAX package is not changed: its functions call the patched ones only
    inside the test."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    matmul, einsum = jnp.matmul, jnp.einsum

    def rounded(ops, precision):
        if precision in (None, jax.lax.Precision.DEFAULT) and \
                any(jnp.asarray(o).dtype == jnp.bfloat16 for o in ops):
            return [jnp.asarray(o).astype(jnp.bfloat16) for o in ops]
        return ops

    def tpu_matmul(a, b, *, precision=None, preferred_element_type=None):
        a, b = rounded([a, b], precision)
        return matmul(a, b, precision=precision,
                      preferred_element_type=preferred_element_type)

    def tpu_einsum(spec, *ops, precision=None, preferred_element_type=None,
                   **kw):
        return einsum(spec, *rounded(ops, precision), precision=precision,
                      preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "matmul", tpu_matmul)
    monkeypatch.setattr(jnp, "einsum", tpu_einsum)


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


@pytest.mark.parametrize("key,T", [("L2", 7), ("L3", 6)])
def test_fast_fused_den_matches_jax_fused_fast(jax_fused, tpu_arithmetic,
                                               monkeypatch, key, T):
    """mode="fast" on the fused path against the JAX fused fast den (its
    scans interpreted at terms = 1, its other products at the TPU's
    arithmetic) at the terms = 6 comparison's bars, but for rounding ties
    on the posteriors: the same single-pass arithmetic on both sides,
    summed in another order."""
    import jax.numpy as jnp
    from kaldi_fp16_tpu_torch.chain import den_structured
    seen = []

    def spy(wrapped):
        def call(*args, **kw):
            seen.append(kw["terms"])
            return wrapped(*args, **kw)
        return call

    for name in ("fused_forward", "fused_backward"):
        monkeypatch.setattr(den_structured, name,
                            spy(getattr(den_structured, name)))
    g = _graph(key)
    x = _nnet((128, T, g.num_pdfs), seed=T + 1)
    den = DenominatorComputation(g, leaky=1e-4, mode="fast",
                                 scan_impl="fused", device="cpu")
    lp, post = den.forward_backward(torch.from_numpy(x))
    assert den._structured.scan_used == "fused" and seen == [1, 1]
    jlp, jpost = jax_fused(g, leaky=1e-4, mode="fast", scan_impl="fused") \
        .forward_backward(jnp.asarray(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=LOGP_RTOL)
    assert_close_but_ties(post.numpy(), jpost, POST_RTOL, POST_ATOL)
    # and it is the fast den: off the exact one by more than fp32 noise
    exact = DenominatorComputation(g, leaky=1e-4, scan_impl="fused",
                                   device="cpu")
    assert float((post - exact.forward_backward(
        torch.from_numpy(x))[1]).abs().max()) > 100 * POST_ATOL


def test_fast_fused_den_matches_the_fast_loop_den():
    """The fused fast den and the loop fast den compute the same single
    bf16 passes (the scans at terms = 1, the loop's products in
    `bf16_product`)."""
    g = _graph("L2")
    x = torch.from_numpy(_nnet((128, 6, g.num_pdfs), seed=11))
    lp_f, post_f = DenominatorComputation(
        g, leaky=1e-4, mode="fast", scan_impl="fused",
        device="cpu").forward_backward(x)
    lp_l, post_l = DenominatorComputation(
        g, leaky=1e-4, mode="fast", scan_impl="loop",
        device="cpu").forward_backward(x)
    torch.testing.assert_close(lp_f, lp_l, rtol=LOGP_RTOL, atol=0)
    assert_close_but_ties(post_f, post_l, POST_RTOL, POST_ATOL)


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
    _plain_scans_vs_jax_kernels(key, 6)


@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("key", ["L2", "L3"])
def test_plain_scans_at_fewer_terms_match_jax_kernels(key, terms):
    """The same at terms 1 (the fast den's single bf16 pass) and 3: the
    port's plain versions compute the split arithmetic itself, the JAX
    kernels `_dot6` at that terms; the products are exact and summed in
    fp32 in both, so the bars stay terms = 6's."""
    _plain_scans_vs_jax_kernels(key, terms)


def _plain_scans_vs_jax_kernels(key, terms):
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
        M.t(), xs_self, xs_fwd, xs_res, init, L=L, T=T, leaky=leaky,
        terms=terms)
    total = a_fin * (1.0 + leaky * sk._init_sum)
    beta = den_scan.fused_backward_plain(
        M, xs_self, xs_fwd, xs_res, asum, init, sk.real, total,
        L=L, T=T, leaky=leaky, terms=terms)

    j = {k: jnp.asarray(v.numpy()) for k, v in (
        ("xs_self", xs_self), ("xs_fwd", xs_fwd), ("xs_res", xs_res),
        ("init", init))}
    orig = mod.pl.pallas_call
    mod.pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    try:
        jhist, stats, jfin = fused_forward(
            split3_matrix(M.t().contiguous().numpy()), j["xs_self"],
            j["xs_fwd"], j["xs_res"], j["init"], L=L, T=T, leaky=leaky,
            terms=terms)
        # the TPU layout: stats [T, 8, N] rows 0/1, a_final / total [8, N]
        jtotal = jfin[0] * (1.0 + leaky * sk._init_sum)
        jbeta = fused_backward(
            split3_matrix(M.numpy()), j["xs_self"], j["xs_fwd"],
            j["xs_res"], stats, j["init"],
            jnp.asarray(sk.real.numpy().astype(np.float32)),
            jnp.zeros((8, 128), jnp.float32).at[0].set(jtotal),
            L=L, T=T, leaky=leaky, terms=terms)
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
    # the JAX name "xla" is the loop; an unknown name raises
    assert DenominatorComputation(g, scan_impl="xla",
                                  device="cpu")._structured.scan_impl == "loop"
    with pytest.raises(ValueError):
        DenominatorComputation(g, scan_impl="pallas", device="cpu")
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


@pytest.mark.gpu
@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("key,T", [("L2", 7), ("L3", 5)])
def test_cuda_scans_at_fewer_terms_against_plain(key, T, terms):
    """The kernels at terms 1 and 3 against the plain versions at the same
    terms, both splits.  At terms = 1 two single bf16 passes drift apart by
    rounding ties over the frames (chip_smoke.py HIST1_REL_TO_MAX): the
    recursion's first two frames at the HIST bars, the whole within two
    bf16 ulps of the largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the den_scan kernels are CUDA only")
    dev = torch.device("cuda")
    sk, tables = _tables(key, T, seed=6)
    xs_self, xs_fwd, xs_res = (t.to(dev) for t in tables)
    M, init, real = sk.M.to(dev), sk.init.to(dev), sk.real.to(dev)
    kw = dict(L=sk.lay.L, T=T, leaky=1e-4, terms=terms)

    def close(a, r, first=slice(0, 2)):
        scale = float(r.abs().max())
        if terms == 1:
            assert float((a - r).abs().max()) <= 2.0 ** -6 * scale
            if a.ndim != 4:
                return
            a, r = a[first], r[first]
        torch.testing.assert_close(a, r, rtol=HIST_RTOL,
                                   atol=HIST_ATOL_REL * scale)

    ref = den_scan.fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                       **kw)
    for planes in (None, split_planes(M, M.shape[0])):
        out = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                     planes=planes, **kw)
        again = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                       planes=planes, **kw)
        torch.cuda.synchronize()
        for a, b, r in zip(out, again, ref):
            assert torch.equal(a, b)
            close(a, r)
        total = out[3] * (1.0 + 1e-4 * sk._init_sum)
        args = (M, xs_self, xs_fwd, xs_res, out[1], init, real, total)
        beta = den_scan.fused_backward(*args, planes=planes, **kw)
        assert torch.equal(beta, den_scan.fused_backward(*args, planes=planes,
                                                         **kw))
        # the beta recursion runs from frame T - 1 down
        close(beta, den_scan.fused_backward_plain(*args, **kw),
              slice(-2, None))
