"""The PyTorch port's blocked denominator against the JAX package's.

The blocked layout runs den graphs that do not decompose into chains
(and any graph with `layout="blocked"`).  Same numpy inputs through
`kaldi_fp16_tpu.chain.denominator` (layout="blocked", posterior_reduce
"einsum" and "pallas", the Pallas reduce interpreting itself off a TPU)
and through the port (posterior_reduce "einsum" and "kernel"), hoisted and
per-frame.  Bars, those of tests/test_chain_denominator.py:175-184: rtol
2e-5 on the log-prob and 2e-4 / atol 2e-6 on the posteriors between
implementations (fp32 recursions summed in another order), and 5e-5
absolute / rtol 1e-3, atol 5e-5 against the float64 oracle.  The host-side
`_BlockedOrder` arrays must equal the JAX originals exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaldi_fp16_tpu.chain import denominator as jax_den
from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.reference import denominator_forward_backward_ref
from kaldi_fp16_tpu_torch.chain import denominator as port_den
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul
from kaldi_fp16_tpu_torch.ops.segment_reduce import segment_reduce

LOGP_RTOL = 2e-5
POST_RTOL, POST_ATOL = 2e-4, 2e-6
ORACLE_LOGP_ATOL, ORACLE_POST_RTOL, ORACLE_POST_ATOL = 5e-5, 1e-3, 5e-5


def _graphs(kind):
    if kind == "simple":          # random ergodic: does not decompose
        fst = jax_graph.make_simple_den_fst(num_pdfs=6, num_states=5, seed=3)
        P = 6
    elif kind == "simple-40":
        fst = jax_graph.make_simple_den_fst(num_pdfs=10, num_states=40,
                                            seed=2)
        P = 10
    else:                         # a phone-LM graph, forced to blocked
        fst = jax_graph.make_phone_lm_den_fst(24, 13, 2, 4, seed=3)
        P = 24
    return (jax_graph.DenominatorGraph.from_fst(fst, P),
            port_graph.DenominatorGraph.from_fst(fst, P))


@pytest.mark.parametrize("kind", ["simple", "simple-40", "phone-lm"])
def test_blocked_orders_equal_the_originals(kind):
    jg, pg = _graphs(kind)
    S, P = jg.num_states, jg.num_pdfs
    for keys, num, secondary in (("dst", S, "src"), ("src", S, "dst"),
                                 ("pdf", P, "src")):
        jo = jax_den._BlockedOrder(getattr(jg, keys), num, jg,
                                   secondary=getattr(jg, secondary))
        po = port_den._BlockedOrder(getattr(pg, keys), num, pg,
                                    secondary=getattr(pg, secondary),
                                    device="cpu")
        assert (po.num_blocks, po.chunks, po.padded) == \
            (jo.num_blocks, jo.chunks, jo.padded)
        np.testing.assert_array_equal(po.onehot, jo.onehot)
        assert po.onehot.dtype == jo.onehot.dtype
        for name in ("local", "src", "dst", "pdf", "prob"):
            a, b = getattr(po, name).numpy(), np.asarray(getattr(jo, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _port(pg, x, **kw):
    lp, post = port_den.DenominatorComputation(pg, layout="blocked",
                                               device="cpu",
                                               **kw).forward_backward(
        torch.from_numpy(x))
    return lp.numpy(), post.numpy()


@pytest.mark.parametrize("kind,N,T", [("simple", 3, 7), ("simple-40", 2, 6),
                                      ("phone-lm", 3, 6)])
@pytest.mark.parametrize("hoist_bytes", [
    pytest.param(1 << 30, id="hoisted"),
    pytest.param(4096, id="per-frame-many-chunks"),
])
@pytest.mark.parametrize("reduce", ["einsum", "kernel"])
def test_blocked_den_matches_jax_and_fp64(kind, N, T, hoist_bytes, reduce):
    jg, pg = _graphs(kind)
    x = np.random.default_rng(T).normal(
        size=(N, T, jg.num_pdfs)).astype(np.float32)
    lp, post = _port(pg, x, leaky=1e-4, hoist_bytes=hoist_bytes,
                     posterior_reduce=reduce)
    jden = jax_den.DenominatorComputation(
        jg, leaky=1e-4, layout="blocked", hoist_bytes=hoist_bytes,
        posterior_reduce="pallas" if reduce == "kernel" else "einsum")
    assert jden.layout_used == "blocked"
    jlp, jpost = jden.forward_backward(jnp.asarray(x))
    np.testing.assert_allclose(lp, np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post, np.asarray(jpost), rtol=POST_RTOL,
                               atol=POST_ATOL)
    for n in range(N):
        rlp, rpost = denominator_forward_backward_ref(jg, x[n], leaky=1e-4)
        assert abs(float(lp[n]) - rlp) < ORACLE_LOGP_ATOL
        np.testing.assert_allclose(post[n], rpost, rtol=ORACLE_POST_RTOL,
                                   atol=ORACLE_POST_ATOL)


@pytest.mark.parametrize("leaky", [1e-4, 1e-5])
def test_blocked_matches_structured_in_the_port(leaky):
    _, pg = _graphs("phone-lm")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 7, 24)).astype(np.float32))
    structured = port_den.DenominatorComputation(pg, leaky=leaky,
                                                 device="cpu")
    assert structured.layout_used == "structured"
    lp_s, post_s = structured.forward_backward(x)
    for reduce in ("einsum", "kernel"):
        lp_b, post_b = port_den.DenominatorComputation(
            pg, leaky=leaky, layout="blocked", posterior_reduce=reduce,
            device="cpu").forward_backward(x)
        torch.testing.assert_close(lp_b, lp_s, rtol=LOGP_RTOL, atol=2e-6)
        torch.testing.assert_close(post_b, post_s, rtol=POST_RTOL,
                                   atol=POST_ATOL)


def test_posterior_reduce_auto_resolves_to_einsum_on_cpu():
    _, pg = _graphs("simple")
    den = port_den.DenominatorComputation(pg, device="cpu")
    assert den.layout_used == "blocked"
    assert den.posterior_reduce == "einsum" and den._oh_pdf is not None
    for reduce in ("einsum", "kernel"):
        den = port_den.DenominatorComputation(pg, posterior_reduce=reduce,
                                              device="cpu")
        assert den.posterior_reduce == reduce
    assert port_den.resolve_posterior_reduce("auto", torch.device("cuda")) \
        == "kernel"
    assert port_den.resolve_posterior_reduce("auto", torch.device("cpu")) \
        == "einsum"
    assert port_den.resolve_posterior_reduce("einsum", torch.device("cuda")) \
        == "einsum"


def test_layouts_options_repeats_and_no_launch_on_cpu():
    jg, pg = _graphs("simple")
    den = port_den.DenominatorComputation(pg, posterior_reduce="kernel",
                                          device="cpu")
    assert den.layout_used == "blocked"
    with pytest.raises(ValueError):
        port_den.DenominatorComputation(pg, layout="structured", device="cpu")
    with pytest.raises(ValueError):
        port_den.DenominatorComputation(pg, layout="dense", device="cpu")
    with pytest.raises(ValueError):
        port_den.DenominatorComputation(pg, posterior_reduce="pallas",
                                        device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 5, 6)).astype(np.float32))
    before = (segment_reduce.launches, DenMatmul.launches)
    lp, post = den.forward_backward(x)
    lp_r, post_r = den.forward_backward(x)
    assert (segment_reduce.launches, DenMatmul.launches) == before
    assert torch.equal(lp, lp_r) and torch.equal(post, post_r)
    assert torch.equal(den.forward(x), lp)
    # posteriors of each frame sum to 1 (all states final)
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, rtol=1e-5)
