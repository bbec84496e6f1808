"""The PyTorch port's structured denominator against the JAX package.

Same numpy inputs through `kaldi_fp16_tpu.chain.denominator` (with
matmul_impl="pallas", the Pallas den matmul run in interpret mode, and
with "high") and through `kaldi_fp16_tpu_torch.chain.denominator`, plus
the float64 oracle `denominator_forward_backward_ref`.  Bars: rtol 2e-5
on the log-prob and 2e-4 / atol 2e-6 on the posteriors, those of
tests/test_pallas_den_matmul.py:94-97 (fp32 recursions over T frames whose
summation order differs between XLA and PyTorch).  The host-side graph and
chain-layout copies must equal the originals exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from kaldi_fp16_tpu.chain import den_structured as jax_ds
from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import (
    DenominatorComputation as JaxDen,
)
from kaldi_fp16_tpu.chain.reference import denominator_forward_backward_ref
from kaldi_fp16_tpu_torch.chain import den_layout
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul

LOGP_RTOL = 2e-5
POST_RTOL, POST_ATOL = 2e-4, 2e-6
SMALL = dict(num_pdfs=24, num_phones=13, states_per_phone=2, branching=4,
             seed=3)


@pytest.fixture
def pallas_interpret(monkeypatch):
    import kaldi_fp16_tpu.ops.pallas_den_matmul as mod
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _graphs(**kw):
    P = kw["num_pdfs"]
    jg = jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(**kw), P)
    pg = port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**kw), P)
    return jg, pg


def _assert_layouts_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("kw", [
    pytest.param(SMALL, id="small"),
    pytest.param(dict(num_pdfs=40, num_phones=30, states_per_phone=3,
                      branching=5, seed=1), id="three-state-phones"),
])
def test_graph_and_layout_copies_equal_the_originals(kw):
    jg, pg = _graphs(**kw)
    for name in ("src", "dst", "pdf", "prob", "initial"):
        np.testing.assert_array_equal(getattr(jg, name), getattr(pg, name))
    assert (jg.num_states, jg.num_pdfs, jg.start_state) == \
        (pg.num_states, pg.num_pdfs, pg.start_state)
    jl = jax_ds.analyze_chain_structure(jg)
    pl_ = den_layout.analyze_chain_structure(pg)
    _assert_layouts_equal(jl, pl_)
    _assert_layouts_equal(jax_ds.pad_chains(jl), den_layout.pad_chains(pl_))


def test_layout_declines_the_same_graphs():
    # a uniformly random graph does not decompose under a small budget
    fst = jax_graph.make_simple_den_fst(num_pdfs=10, num_states=40, seed=2)
    jg = jax_graph.DenominatorGraph.from_fst(fst, 10)
    pg = port_graph.DenominatorGraph.from_fst(fst, 10)
    assert jax_ds.analyze_chain_structure(jg, max_dense_states=8) is None
    assert den_layout.analyze_chain_structure(pg, max_dense_states=8) is None


def _run_port(pg, x, **kw):
    lp, post = DenominatorComputation(pg, device="cpu", **kw).forward_backward(
        torch.from_numpy(x))
    return lp.numpy(), post.numpy()


@pytest.mark.parametrize("hoist_bytes", [
    pytest.param(1 << 30, id="hoisted-one-chunk"),
    # 2 frames of slot values fit (52 slots x N=3 x 16 bytes each): chunks
    # of 2, 2, 2 and 1 frames, and the per-frame (un-hoisted) emissions
    pytest.param(2 * 52 * 3 * 16, id="per-frame-many-chunks"),
])
@pytest.mark.parametrize("leaky", [1e-4, 1e-5])
def test_structured_den_matches_jax_and_fp64(pallas_interpret, hoist_bytes,
                                             leaky):
    jg, pg = _graphs(**SMALL)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    lp, post = _run_port(pg, x, leaky=leaky, hoist_bytes=hoist_bytes)
    for impl in ("pallas", "high"):
        jden = JaxDen(jg, leaky=leaky, matmul_impl=impl,
                      hoist_bytes=hoist_bytes)
        jlp, jpost = jden.forward_backward(jnp.asarray(x))
        np.testing.assert_allclose(lp, np.asarray(jlp), rtol=LOGP_RTOL)
        np.testing.assert_allclose(post, np.asarray(jpost), rtol=POST_RTOL,
                                   atol=POST_ATOL)
    for b in range(x.shape[0]):
        rlp, rpost = denominator_forward_backward_ref(jg, x[b], leaky=leaky)
        np.testing.assert_allclose(lp[b], rlp, rtol=LOGP_RTOL)
        np.testing.assert_allclose(post[b], rpost, rtol=POST_RTOL,
                                   atol=POST_ATOL)


def test_three_state_chains_and_clipped_outputs():
    """L=3 chains (two chain-arc rows) and outputs beyond the +/-30 clip."""
    kw = dict(num_pdfs=40, num_phones=30, states_per_phone=3, branching=5,
              seed=1)
    jg, pg = _graphs(**kw)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 40)).astype(np.float32)
    x[0, 1, :5] = 45.0
    x[1, 3, 5:9] = -45.0
    lp, post = _run_port(pg, x, leaky=1e-5)
    jlp, jpost = JaxDen(jg, leaky=1e-5, matmul_impl="high").forward_backward(
        jnp.asarray(x))
    np.testing.assert_allclose(lp, np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post, np.asarray(jpost), rtol=POST_RTOL,
                               atol=POST_ATOL)


def test_forward_only_and_plain_impl_agree():
    _, pg = _graphs(**SMALL)
    x = np.random.default_rng(5).normal(size=(2, 5, 24)).astype(np.float32)
    kernel = DenominatorComputation(pg, leaky=1e-5, device="cpu")
    plain = DenominatorComputation(pg, leaky=1e-5, matmul_impl="plain",
                                   device="cpu")
    lp_k, post_k = kernel.forward_backward(torch.from_numpy(x))
    lp_p, post_p = plain.forward_backward(torch.from_numpy(x))
    # on the CPU the kernel path computes the same plain fp32 products
    assert torch.equal(lp_k, lp_p) and torch.equal(post_k, post_p)
    assert torch.equal(kernel.forward(torch.from_numpy(x)), lp_k)
    # repeats are bit-identical
    lp_r, post_r = kernel.forward_backward(torch.from_numpy(x))
    assert torch.equal(lp_r, lp_k) and torch.equal(post_r, post_k)
    # posteriors of each frame sum to 1 (all states final)
    np.testing.assert_allclose(post_k.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_no_kernel_launch_on_cpu_and_no_blocked_fallback():
    from kaldi_fp16_tpu_torch.ops.segment_reduce import segment_reduce
    _, pg = _graphs(**SMALL)
    before = DenMatmul.launches
    DenominatorComputation(pg, device="cpu").forward_backward(
        torch.zeros(1, 3, 24))
    assert DenMatmul.launches == before
    # a random graph takes the blocked layout, which launches nothing on
    # the CPU either (its reduce kernel's plain version runs there)
    uniform = port_graph.DenominatorGraph.from_fst(
        port_graph.make_simple_den_fst(num_pdfs=10, num_states=8, seed=2), 10)
    den = DenominatorComputation(uniform, posterior_reduce="kernel",
                                 device="cpu")
    assert den.layout_used == "blocked"
    before = (DenMatmul.launches, segment_reduce.launches)
    lp, post = den.forward_backward(torch.zeros(1, 3, 10))
    assert (DenMatmul.launches, segment_reduce.launches) == before
    assert torch.isfinite(lp).all() and torch.isfinite(post).all()
    with pytest.raises(ValueError):
        DenominatorComputation(pg, matmul_impl="split3", device="cpu")


def test_fp64_oracle_copy_equals_the_original():
    from kaldi_fp16_tpu.chain import reference as jax_ref
    from kaldi_fp16_tpu.io.sparse import fst_to_csr
    from kaldi_fp16_tpu_torch.chain import reference as port_ref
    from tests.test_chain_numerator import random_fst
    jg, pg = _graphs(**SMALL)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 24)).astype(np.float32)
    csr = fst_to_csr(random_fst(rng, num_states=10, num_pdfs=24, T=4))
    for fn, graph_a, graph_b in (
            ("denominator_forward_backward_ref", jg, pg),
            ("numerator_forward_backward_ref", csr, csr)):
        lp_a, post_a = getattr(jax_ref, fn)(graph_a, x)
        lp_b, post_b = getattr(port_ref, fn)(graph_b, x)
        assert lp_a == lp_b, fn
        np.testing.assert_array_equal(post_a, post_b, err_msg=fn)
    assert (jax_ref.denominator_brute_force(jg, x)
            == port_ref.denominator_brute_force(pg, x))
    assert (jax_ref.numerator_brute_force(csr, x)
            == port_ref.numerator_brute_force(csr, x))
