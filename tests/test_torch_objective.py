"""The PyTorch port's chain objective against the JAX package.

`_chain_core` of both packages gets the same numpy nnet output, weights,
deriv-weights and graphs; objf, deriv and num_post must agree.  The
objective is fp32 and sums many terms in different orders, so values are
held to rtol 2e-5 and derivatives (posterior differences) to the den
posterior bar, rtol 2e-4 / atol 2e-6 (tests/test_pallas_den_matmul.py:94-97).
The autograd.Function's gradient is also checked against central finite
differences taken in float64 along random directions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import (
    ChainTrainingOpts as JaxOpts, _chain_core as jax_chain_core,
)
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import (
    ChainTrainingOpts, chain_core, make_chain_objf_with_post,
)
from tests.test_chain_numerator import random_fst

P, T, B = 16, 6, 3
VAL_RTOL = 2e-5
DERIV_RTOL, DERIV_ATOL = 2e-4, 2e-6
DEN_KW = dict(num_pdfs=P, num_phones=9, states_per_phone=2, branching=3,
              seed=5)


def _setup(dead_final=False):
    rng = np.random.default_rng(7)
    fsts = [random_fst(rng, num_states=2 * (T + 1), num_pdfs=P, T=T)
            for _ in range(B)]
    if dead_final:
        s = [FstState() for _ in range(2)]
        s[0].arcs = [FstArc(1, 0.1, 0)]     # final state 1 never reached
        s[1].final = 0.0
        fsts[1] = Fst(start=0, states=s)
    csrs = [fst_to_csr(f) for f in fsts]
    jnum = jax_graph.build_numerator_batch(csrs)
    pnum = port_graph.build_numerator_batch(csrs)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5)
    pden = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**DEN_KW), P), leaky=1e-5,
        device="cpu")
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    x[0, 0, :3] = [35.0, -41.0, 31.0]       # even frame: penalised
    x[0, 1, 3] = 50.0                       # odd frame: not penalised
    x[2, 4, 5] = -33.0                      # even frame: penalised
    w = np.array([1.0, 0.5, 2.0], np.float32)
    dw = rng.uniform(0.0, 1.0, size=(B, T)).astype(np.float32)
    return jnum, pnum, jden, pden, x, w, dw


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("use_dw", [False, True])
@pytest.mark.parametrize("dead_final", [False, True])
def test_chain_core_matches_jax(l2, use_dw, dead_final):
    jnum, pnum, jden, pden, x, w, dw = _setup(dead_final)
    jres, jderiv, jpost = jax_chain_core(
        jnum, jden, jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(dw) if use_dw else None,
        JaxOpts(l2_regularize=l2))
    res, deriv, post = chain_core(
        pnum, pden, torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(dw) if use_dw else None,
        ChainTrainingOpts(l2_regularize=l2))
    for name in ("total_objf", "l2_term", "total_weight", "num_logprob",
                 "den_logprob", "objf_per_frame"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=VAL_RTOL, atol=1e-6, err_msg=name)
    assert int(res.out_of_range_count) == int(jres.out_of_range_count) == 4
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    assert bool(res.ok[1]) != dead_final
    if dead_final:                          # containment: -10 * w * T
        assert not deriv[1].any()
    np.testing.assert_allclose(deriv.numpy(), np.asarray(jderiv),
                               rtol=DERIV_RTOL, atol=DERIV_ATOL)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost),
                               rtol=DERIV_RTOL, atol=DERIV_ATOL)


def test_autograd_function_backward_and_finite_differences():
    _, pnum, _, pden, x, w, dw = _setup()
    opts = ChainTrainingOpts(l2_regularize=0.01)
    objf_fn = make_chain_objf_with_post(pnum, pden, opts)
    xt = torch.from_numpy(x).requires_grad_(True)
    objf, result, num_post = objf_fn(xt, torch.from_numpy(w), None)
    assert not num_post.requires_grad
    (grad,) = torch.autograd.grad(2.5 * objf, xt)
    _, deriv, _ = chain_core(pnum, pden, torch.from_numpy(x),
                             torch.from_numpy(w), None, opts)
    # backward returns g * deriv
    torch.testing.assert_close(grad, 2.5 * deriv, rtol=0, atol=0)

    # the penalty is not the gradient of the objective, so check the chain
    # and L2 terms away from the +/-30 limit
    x_in = np.clip(x, -20, 20)
    rng = np.random.default_rng(1)
    xt = torch.from_numpy(x_in).requires_grad_(True)
    objf, _, _ = objf_fn(xt, torch.from_numpy(w), None)
    (g,) = torch.autograd.grad(objf, xt)
    g = g.double().numpy()
    h = 1e-2
    for _ in range(3):
        d = rng.normal(size=x.shape)
        f = [float(objf_fn(torch.from_numpy((x_in + s * h * d)
                                            .astype(np.float32)),
                           torch.from_numpy(w), None)[0])
             for s in (1.0, -1.0)]
        fd = (np.float64(f[0]) - np.float64(f[1])) / (2 * h)
        # fp32 objective values (~1e2) carry ~1e-5 absolute noise, /2h
        np.testing.assert_allclose(fd, float(np.sum(g * d)), rtol=2e-3,
                                   atol=2e-3)
