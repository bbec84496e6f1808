"""The PyTorch port's numerator forward-backward against the JAX package.

Same numpy inputs through `kaldi_fp16_tpu.chain.numerator` (the jitted
lax.scan with one-hot matmuls) and `kaldi_fp16_tpu_torch.chain.numerator`,
and through the float64 oracle `numerator_forward_backward_ref`.  Both are
fp32 log-domain recursions; they differ in the order of the per-state sums
only, so log-probs agree to rtol 1e-5 and posteriors to 1e-4 / atol 1e-6
(the JAX package's own oracle bars in tests/test_chain_numerator.py are
of that class).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaldi_fp16_tpu.chain.graph import build_numerator_batch
from kaldi_fp16_tpu.chain.numerator import numerator_forward_backward as jax_num
from kaldi_fp16_tpu.chain.reference import numerator_forward_backward_ref
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO
from kaldi_fp16_tpu_torch.chain.numerator import numerator_forward_backward
from tests.test_chain_numerator import random_fst

LOGP_RTOL = 1e-5
POST_RTOL, POST_ATOL = 1e-4, 1e-6
P = 7


def _fsts(rng, T):
    fsts = [random_fst(rng, num_states=3 * (T + 1), num_pdfs=P, T=T)
            for _ in range(2)]
    # an arc whose label is beyond num_pdfs (malformed graph): skipped
    bad = random_fst(rng, num_states=2 * (T + 1), num_pdfs=P, T=T)
    bad.states[0].arcs.append(FstArc(P + 3, 0.2, bad.states[0].arcs[0]
                                     .next_state))
    fsts.append(bad)
    # an unreachable final state: total LOG_ZERO, posteriors zeroed
    dead = [FstState() for _ in range(3)]
    dead[0].arcs = [FstArc(1, 0.1, 1)]
    dead[1].arcs = [FstArc(2, 0.3, 1)]
    dead[2].final = 0.0
    fsts.append(Fst(start=0, states=dead))
    return fsts


def _batch(fsts):
    csrs = [fst_to_csr(f) for f in fsts]
    jb = build_numerator_batch(csrs)
    pb = port_graph.build_numerator_batch(csrs)
    for name in ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask",
                 "start", "final_logw"):
        np.testing.assert_array_equal(getattr(jb, name), getattr(pb, name))
    return csrs, jb, pb


@pytest.mark.parametrize("T", [4, 6])
def test_numerator_matches_jax_and_fp64(T):
    rng = np.random.default_rng(T)
    csrs, jb, pb = _batch(_fsts(rng, T))
    x = rng.normal(size=(len(csrs), T, P)).astype(np.float32)
    lp, post = numerator_forward_backward(pb, torch.from_numpy(x))
    lp, post = lp.numpy(), post.numpy()
    jlp, jpost = jax_num(jb, jnp.asarray(x))
    np.testing.assert_allclose(lp, np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post, np.asarray(jpost), rtol=POST_RTOL,
                               atol=POST_ATOL)
    for b, csr in enumerate(csrs):
        rlp, rpost = numerator_forward_backward_ref(csr, x[b])
        if rlp <= LOG_ZERO:
            assert lp[b] == LOG_ZERO
            assert not post[b].any()
        else:
            np.testing.assert_allclose(lp[b], rlp, rtol=LOGP_RTOL)
            np.testing.assert_allclose(post[b], rpost, rtol=POST_RTOL,
                                       atol=POST_ATOL)
    assert lp[-1] == LOG_ZERO          # the unreachable final


def test_bench_shaped_supervision():
    """bench.py's linear supervision (every arc consumes one frame, with
    parallel alternative-pdf arcs): finite total, one unit of posterior mass
    per frame, equal to JAX."""
    rng = np.random.default_rng(0)
    B, T, An = 3, 5, 12
    Sn = T + 1
    kw = dict(
        arc_src=np.tile(np.arange(An, dtype=np.int32) % T, (B, 1)),
        arc_dst=np.tile(np.arange(An, dtype=np.int32) % T + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)
    from kaldi_fp16_tpu.chain.graph import NumeratorGraphBatch as JaxBatch
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    lp, post = numerator_forward_backward(port_graph.NumeratorGraphBatch(**kw),
                                          torch.from_numpy(x))
    jlp, jpost = jax_num(JaxBatch(**kw), jnp.asarray(x))
    assert np.all(lp.numpy() > -1e20)
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost),
                               rtol=POST_RTOL, atol=POST_ATOL)
