"""The chain objective's functional API, the den's functional wrapper and
the sparse helpers of the port against the JAX package's, on the CPU.

* `chain_objf_and_deriv`, `chain_objf`, `chain_loss_and_grad` and the
  gradient of `make_chain_objf` against the JAX functions on the same
  numpy inputs: values at rtol 2e-5, derivatives at rtol 2e-4 / atol 2e-6
  (tests/test_torch_objective.py's bars, from
  tests/test_pallas_den_matmul.py:94-97).
* The cases of tests/test_chain_objective.py:71-142 (supervision weight,
  L2, OOR, NaN containment, deriv_weights, result fields) on the port,
  each also held to the JAX function.
* `denominator_forward_backward` against the JAX function and the float64
  oracle (tests/test_chain_denominator.py:98's bars), and its cache.
* `csr_to_coo` / `merge_coo` against the JAX functions on
  tests/test_sparse.py's inputs, bit for bit.
* The chain package's exports, the objective's loaded on first use.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain import objective as jax_obj
from kaldi_fp16_tpu.chain.denominator import (
    DenominatorComputation as JaxDen,
    denominator_forward_backward as jax_den_fb,
)
from kaldi_fp16_tpu.io import fst as jax_fst
from kaldi_fp16_tpu.io import sparse as jax_sparse
from kaldi_fp16_tpu_torch.chain import denominator as port_den
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain import objective as port_obj
from kaldi_fp16_tpu_torch.chain.reference import (
    denominator_forward_backward_ref,
)
from kaldi_fp16_tpu_torch.io import fst as port_fst
from kaldi_fp16_tpu_torch.io import sparse as port_sparse
from tests.test_chain_numerator import random_fst

VAL_RTOL = 2e-5
DERIV = dict(rtol=2e-4, atol=2e-6)
P, T, B = 16, 6, 3
DEN_KW = dict(num_pdfs=P, num_phones=9, states_per_phone=2, branching=3,
              seed=5)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def check_result(res, jres):
    for name in ("total_objf", "l2_term", "total_weight", "num_logprob",
                 "den_logprob", "objf_per_frame"):
        np.testing.assert_allclose(
            getattr(res, name).detach().numpy(),
            np.asarray(getattr(jres, name)), rtol=VAL_RTOL, atol=1e-6,
            err_msg=name)
    assert int(res.out_of_range_count) == int(jres.out_of_range_count)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))


@pytest.fixture(scope="module")
def phone_lm():
    """test_torch_objective.py's inputs: a small phone-LM den, OOR values
    on even and odd frames, supervision weights, per-frame weights."""
    rng = np.random.default_rng(7)
    csrs = [port_sparse.fst_to_csr(random_fst(rng, num_states=2 * (T + 1),
                                              num_pdfs=P, T=T))
            for _ in range(B)]
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5)
    pden = port_den.DenominatorComputation(
        port_graph.DenominatorGraph.from_fst(
            port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    x[0, 0, :3] = [35.0, -41.0, 31.0]
    x[0, 1, 3] = 50.0
    x[2, 4, 5] = -33.0
    w = np.array([1.0, 0.5, 2.0], np.float32)
    dw = rng.uniform(0.0, 1.0, size=(B, T)).astype(np.float32)
    return (jax_graph.build_numerator_batch(csrs),
            port_graph.build_numerator_batch(csrs), jden, pden, x, w, dw)


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("weighted", [False, True])
def test_functional_api_matches_jax(phone_lm, l2, weighted):
    jnum, pnum, jden, pden, x, w, dw = phone_lm
    jopts = jax_obj.ChainTrainingOpts(l2_regularize=l2)
    popts = port_obj.ChainTrainingOpts(l2_regularize=l2)
    jw, pw = (j(w), t(w)) if weighted else (None, None)

    jres, jderiv = jax_obj.chain_objf_and_deriv(jnum, jden, j(x), jw, j(dw),
                                                jopts)
    res, deriv = port_obj.chain_objf_and_deriv(pnum, pden, t(x), pw, t(dw),
                                               popts)
    check_result(res, jres)
    np.testing.assert_allclose(deriv.numpy(), np.asarray(jderiv), **DERIV)

    jobjf, jres = jax_obj.chain_objf(jnum, jden, j(x), jw, jopts)
    objf, res = port_obj.chain_objf(pnum, pden, t(x), pw, popts)
    np.testing.assert_allclose(float(objf), float(jobjf), rtol=VAL_RTOL)
    check_result(res, jres)

    jloss, jres, jgrad = jax_obj.chain_loss_and_grad(jnum, jden, j(x), jw,
                                                     jopts)
    loss, res, grad = port_obj.chain_loss_and_grad(pnum, pden, t(x), pw,
                                                   popts)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=VAL_RTOL)
    check_result(res, jres)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **DERIV)

    # make_chain_objf: the gradient of 2.5 * objf, weights non-differentiable
    ones = np.ones(B, np.float32)
    wv = w if weighted else ones
    jfn = jax_obj.make_chain_objf(jnum, jden, jopts)
    jg = jax.grad(lambda o: 2.5 * jfn(o, j(wv))[0])(j(x))
    fn = port_obj.make_chain_objf(pnum, pden, popts)
    xt = t(x).clone().requires_grad_(True)
    wt = t(wv).clone().requires_grad_(True)
    objf, res = fn(xt, wt)
    assert not res.total_objf.requires_grad
    gx, gw = torch.autograd.grad(2.5 * objf, (xt, wt), allow_unused=True)
    assert gw is None
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg), **DERIV)


# tests/test_chain_objective.py's fixture: a 5-state random den, T = 4
NP, NT, NB = 6, 4, 2


@pytest.fixture(scope="module")
def simple():
    rng = np.random.default_rng(7)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_simple_den_fst(num_pdfs=NP, num_states=5, seed=1),
        NP), leaky=1e-4)
    pden = port_den.DenominatorComputation(
        port_graph.DenominatorGraph.from_fst(
            port_graph.make_simple_den_fst(num_pdfs=NP, num_states=5,
                                           seed=1), NP),
        leaky=1e-4, device="cpu")
    csrs = [port_sparse.fst_to_csr(random_fst(rng, num_pdfs=NP, T=NT))
            for _ in range(NB)]
    out = rng.normal(size=(NB, NT, NP)).astype(np.float32) * 0.5
    return (jden, pden, jax_graph.build_numerator_batch(csrs),
            port_graph.build_numerator_batch(csrs), out)


def both(simple, out, graphs=None, **kw):
    """chain_objf_and_deriv of both packages: the port's (result, deriv),
    each held to the JAX function's."""
    jden, pden, jnum, pnum, _ = simple
    if graphs is not None:
        jnum, pnum = graphs
    opts = kw.pop("opts", {})
    jres, jd = jax_obj.chain_objf_and_deriv(
        jnum, jden, j(out), opts=jax_obj.ChainTrainingOpts(**opts),
        **{k: j(v) for k, v in kw.items()})
    res, d = port_obj.chain_objf_and_deriv(
        pnum, pden, t(out), opts=port_obj.ChainTrainingOpts(**opts),
        **{k: t(v) for k, v in kw.items()})
    check_result(res, jres)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **DERIV)
    return res, d.numpy()


def test_supervision_weight_scales(simple):
    out = simple[-1]
    no_oor = dict(out_of_range_regularize=0.0)
    r1, d1 = both(simple, out, opts=no_oor)
    r2, d2 = both(simple, out, opts=no_oor,
                  weights=np.full(NB, 2.0, np.float32))
    np.testing.assert_allclose(float(r2.total_objf),
                               2 * float(r1.total_objf), rtol=1e-5)
    np.testing.assert_allclose(d2, 2 * d1, rtol=1e-4, atol=1e-7)


def test_l2_term(simple):
    out = simple[-1]
    r, d = both(simple, out, opts=dict(out_of_range_regularize=0.0,
                                       l2_regularize=0.1))
    expected = -0.5 * 0.1 * float((out.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(float(r.l2_term), expected, rtol=1e-4)
    _, d0 = both(simple, out, opts=dict(out_of_range_regularize=0.0))
    np.testing.assert_allclose(d, d0 - 0.1 * out, rtol=1e-4, atol=1e-6)


def test_out_of_range_penalty(simple):
    out = np.zeros((NB, NT, NP), dtype=np.float32)
    out[0, 0, 0] = 35.0     # even frame: penalised
    out[0, 1, 1] = 35.0     # odd frame: skipped
    out[1, 2, 2] = -40.0    # even frame: penalised
    r, d = both(simple, out)
    assert int(r.out_of_range_count) == 2
    _, d0 = both(simple, out, opts=dict(out_of_range_regularize=0.0))
    scale = 2 * 0.01
    np.testing.assert_allclose(d[0, 0, 0] - d0[0, 0, 0], (30 - 35) * scale,
                               atol=1e-6)
    np.testing.assert_allclose(d[0, 1, 1] - d0[0, 1, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(d[1, 2, 2] - d0[1, 2, 2], (-30 + 40) * scale,
                               atol=1e-6)


def test_nan_containment(simple):
    """A numerator FST that needs more frames than T has total LOG_ZERO:
    objf := -10 * w * T and a zero deriv for that sequence."""
    rng = np.random.default_rng(3)
    bad = port_sparse.fst_to_csr(random_fst(rng, num_pdfs=NP, T=NT + 2))
    good = port_sparse.fst_to_csr(random_fst(rng, num_pdfs=NP, T=NT))
    r, d = both(simple, simple[-1],
                graphs=(jax_graph.build_numerator_batch([bad, good]),
                        port_graph.build_numerator_batch([bad, good])))
    assert not bool(r.ok[0]) and bool(r.ok[1])
    assert np.abs(d[0]).max() == 0.0 and np.abs(d[1]).max() > 0.0
    assert np.isfinite(float(r.total_objf))


def test_deriv_weights(simple):
    dw = np.zeros((NB, NT), dtype=np.float32)
    dw[:, :2] = 1.0
    _, d = both(simple, simple[-1], deriv_weights=dw)
    assert np.abs(d[:, 2:]).max() == 0.0 and np.abs(d[:, :2]).max() > 0.0


def test_result_fields(simple):
    r, _ = both(simple, simple[-1])
    assert float(r.total_weight) == NB * NT
    np.testing.assert_allclose(float(r.objf_per_frame),
                               float(r.total_objf) / (NB * NT), rtol=1e-6)
    assert float(r.num_logprob[0]) < 0 or float(r.den_logprob[0]) < 0


# tests/test_chain_denominator.py's graph and bars
@pytest.fixture(scope="module")
def den_graphs():
    return (jax_graph.DenominatorGraph.from_fst(
                jax_graph.make_simple_den_fst(num_pdfs=NP, num_states=5,
                                              seed=3), NP),
            port_graph.DenominatorGraph.from_fst(
                port_graph.make_simple_den_fst(num_pdfs=NP, num_states=5,
                                               seed=3), NP))


@pytest.mark.parametrize("n,frames", [(1, 4), (3, 5)])
def test_denominator_forward_backward_matches_jax_and_oracle(den_graphs, n,
                                                            frames):
    jg, pg = den_graphs
    out = np.random.default_rng(n).normal(size=(n, frames, NP)) \
        .astype(np.float32)
    logp, post = port_den.denominator_forward_backward(pg, t(out))
    jlogp, jpost = jax_den_fb(jg, j(out))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                               rtol=VAL_RTOL)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost), **DERIV)
    for b in range(n):
        ref_logp, ref_post = denominator_forward_backward_ref(pg, out[b])
        assert abs(float(logp[b]) - ref_logp) < 5e-4
        np.testing.assert_allclose(post[b].numpy(), ref_post, rtol=1e-4,
                                   atol=1e-5)


def test_denominator_forward_backward_cache(den_graphs, monkeypatch):
    """One computation per (graph, leaky, mode, device), held to its
    graph; the cache is cleared above 16 entries; mode "fast" is the
    revoked mode and raises."""
    pg = den_graphs[1]
    monkeypatch.setattr(port_den, "_den_cache", {})
    cache = port_den._den_cache
    out = t(np.random.default_rng(0).normal(size=(2, 3, NP))
            .astype(np.float32))
    port_den.denominator_forward_backward(pg, out)
    (key, (graph, den)), = cache.items()
    assert graph is pg and den.leaky == 1e-5 and den.layout_used
    port_den.denominator_forward_backward(pg, out)
    assert len(cache) == 1 and cache[key][1] is den
    port_den.denominator_forward_backward(pg, out, leaky=1e-4)
    assert len(cache) == 2 and cache[key][1] is den
    other = port_graph.DenominatorGraph.from_fst(
        port_graph.make_simple_den_fst(num_pdfs=NP, num_states=5, seed=3),
        NP)
    port_den.denominator_forward_backward(other, out)
    assert len(cache) == 3
    for i in range(15):
        port_den.denominator_forward_backward(pg, out, leaky=1e-3 + i)
    assert len(cache) == 1     # cleared when the 18th entry came
    with pytest.raises(ValueError, match="queue 1 item 5"):
        port_den.denominator_forward_backward(pg, out, mode="fast")


def tiny(fst_mod):
    """tests/test_sparse.py's three-state FST in either package's classes."""
    s0, s1, s2 = fst_mod.FstState(), fst_mod.FstState(), fst_mod.FstState()
    s0.arcs = [fst_mod.FstArc(1, 0.5, 1), fst_mod.FstArc(2, 1.5, 2)]
    s1.arcs = [fst_mod.FstArc(3, 0.25, 2)]
    s2.final = 0.75
    return fst_mod.Fst(start=0, states=[s0, s1, s2])


def assert_coo_equal(a, b):
    assert a.num_states == b.num_states and a.start_state == b.start_state
    for name in ("rows", "cols", "labels", "weights", "final_states",
                 "final_weights"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_csr_to_coo_and_merge_coo_match_jax():
    pcoo = port_sparse.fst_to_coo(tiny(port_fst))
    jcoo = jax_sparse.fst_to_coo(tiny(jax_fst))
    back = port_sparse.csr_to_coo(port_sparse.coo_to_csr(pcoo))
    assert_coo_equal(back, jax_sparse.csr_to_coo(jax_sparse.coo_to_csr(
        jcoo)))
    np.testing.assert_array_equal(back.rows, pcoo.rows)
    np.testing.assert_array_equal(back.cols, pcoo.cols)

    merged, offsets = port_sparse.merge_coo([pcoo, pcoo])
    jmerged, joffsets = jax_sparse.merge_coo([jcoo, jcoo])
    assert_coo_equal(merged, jmerged)
    assert offsets.dtype == joffsets.dtype
    np.testing.assert_array_equal(offsets, joffsets)
    np.testing.assert_array_equal(offsets, [0, 3])
    assert merged.num_states == 6 and merged.num_arcs == 6
    np.testing.assert_array_equal(merged.final_states, [2, 5])
    with pytest.raises(ValueError):
        port_sparse.merge_coo([])


def test_chain_package_loads_the_objective_on_first_use():
    """kaldi_fp16_tpu_torch.chain exports the JAX package's names; the
    objective's load on first use (the data path imports chain.graph and
    stays free of torch)."""
    import kaldi_fp16_tpu_torch.chain as chain
    for name in ("ChainResult", "ChainTrainingOpts", "chain_loss_and_grad",
                 "chain_objf"):
        assert getattr(chain, name) is getattr(port_obj, name)
    assert chain.DenominatorGraph is port_graph.DenominatorGraph
    with pytest.raises(AttributeError):
        chain.make_chain_objf_with_posts
