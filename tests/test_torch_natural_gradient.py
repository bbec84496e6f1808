"""The port's NG-SGD estimator against the JAX package's.

The same sample matrices (numpy, from a seed) go through the JAX
`ng_update` and the port's, from the same start.  Eigenvectors are only
defined up to sign (and, in degenerate subspaces, rotation), so V is
never compared; the invariants are: d and rho (rtol 1e-4, fp32 eigensolves
in two libraries), the counter t (exactly), the learned factor Vᵀdiag(d)V
(within 1e-4 of its largest entry) and the preconditioned gradient (rtol
1e-4, atol 1e-6 * ||dw||), after 1 and 5 updates.  The cases follow
tests/test_natural_gradient.py: norm preservation, the update period.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.training import natural_gradient as J
from kaldi_fp16_tpu_torch.training import natural_gradient as P

D = 40
RTOL = 1e-4


def cov(state):
    v, d = np.asarray(state.v, np.float64), np.asarray(state.d, np.float64)
    return v.T @ np.diag(d) @ v


def run_both(updates, dim=D, rank=8, period=1, seed=0, n=64):
    rng = np.random.default_rng(seed)
    jcfg = J.NGConfig(rank=rank, update_period=period)
    pcfg = P.NGConfig(rank=rank, update_period=period)
    js, ps = J.init_ng_state(dim, jcfg), P.init_ng_state(dim, pcfg, "cpu")
    scales = np.linspace(5.0, 0.1, dim)
    jit_update = jax.jit(J.ng_update, static_argnums=2)
    for _ in range(updates):
        x = (rng.normal(size=(n, dim)) * scales).astype(np.float32)
        js = jit_update(js, jnp.asarray(x), jcfg)
        ps = P.ng_update(ps, torch.from_numpy(x), pcfg)
    return js, ps, jcfg, pcfg


def assert_invariants_close(js, ps):
    assert int(ps.t) == int(js.t)
    np.testing.assert_allclose(ps.d.numpy(), np.asarray(js.d), rtol=RTOL,
                               atol=RTOL * float(np.max(np.asarray(js.d))))
    np.testing.assert_allclose(float(ps.rho), float(js.rho), rtol=RTOL)
    cj = cov(js)
    np.testing.assert_allclose(cov(ps), cj, rtol=0,
                               atol=RTOL * np.abs(cj).max())


def test_init_state_matches():
    js, ps = J.init_ng_state(D), P.init_ng_state(D, device="cpu")
    np.testing.assert_allclose(ps.v.numpy(), np.asarray(js.v), atol=1e-6)
    g = ps.v @ ps.v.T
    np.testing.assert_allclose(g.numpy(), np.eye(g.shape[0]), atol=1e-5)
    assert float(ps.rho) == float(js.rho) and int(ps.t) == 0


@pytest.mark.parametrize("updates", [1, 5])
def test_estimator_invariants_match_jax(updates):
    js, ps, *_ = run_both(updates)
    assert_invariants_close(js, ps)
    # orthonormal rows
    g = (ps.v @ ps.v.T).numpy()
    np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-4)


@pytest.mark.parametrize("updates", [1, 5])
def test_preconditioned_gradient_matches_jax(updates):
    js_in, ps_in, jcfg, pcfg = run_both(updates, dim=D, seed=1)
    js_out, ps_out, *_ = run_both(updates, dim=12, rank=4, seed=2, n=96)
    dw = np.random.default_rng(3).normal(size=(D, 12)).astype(np.float32)
    ref = np.asarray(jax.jit(J.precondition_grad, static_argnums=3)(
        js_in, js_out, jnp.asarray(dw), jcfg))
    got = P.precondition_grad(ps_in, ps_out, torch.from_numpy(dw),
                              pcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-6 * np.linalg.norm(dw))
    # the Frobenius norm is preserved
    np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(dw),
                               rtol=1e-5)
    x = np.random.default_rng(4).normal(size=(32, D)).astype(np.float32)
    ref_s = np.asarray(jax.jit(J.precondition_samples, static_argnums=2)(
        js_in, jnp.asarray(x), jcfg))
    got_s = P.precondition_samples(ps_in, torch.from_numpy(x), pcfg).numpy()
    np.testing.assert_allclose(got_s, ref_s, rtol=RTOL,
                               atol=1e-6 * np.linalg.norm(x))


def test_update_period_skips_and_counts():
    js, ps, *_ = run_both(6, period=4)
    assert int(ps.t) == int(js.t) == 6
    assert_invariants_close(js, ps)
    # the 2nd call after an update only advances the counter
    cfg = P.NGConfig(rank=4, update_period=4)
    st = P.init_ng_state(D, cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(32, D)).astype(np.float32))
    st1 = P.ng_update(st, x, cfg)
    st2 = P.ng_update(st1, x, cfg)
    assert int(st2.t) == 2 and torch.equal(st2.v, st1.v)
    assert P.update_due(0, cfg) and not P.update_due(3, cfg)
    assert P.update_due(4, cfg)


def test_batched_update_equals_one_at_a_time():
    """fisher_update over several same-shape states (the train step's
    batched eigensolves) equals updating each alone."""
    cfg = P.NGConfig(rank=6, update_period=1)
    rng = np.random.default_rng(6)
    states = [P.init_ng_state(D, cfg, "cpu") for _ in range(3)]
    xs = [torch.from_numpy((rng.normal(size=(n, D))
                            * np.linspace(3.0, 0.2, D)).astype(np.float32))
          for n in (40, 64, 100)]
    states = P.fisher_update(states, xs, cfg)        # leave the init basis
    together = P.fisher_update(states, xs, cfg)
    for st, x, t in zip(states, xs, together):
        alone = P.fisher_update([st], [x], cfg)[0]
        np.testing.assert_allclose(t.d.numpy(), alone.d.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(alone.d.max()))
        np.testing.assert_allclose(float(t.rho), float(alone.rho), rtol=1e-5)
        np.testing.assert_allclose(cov(t), cov(alone), rtol=0,
                                   atol=1e-5 * np.abs(cov(alone)).max())
        assert int(t.t) == int(alone.t) == 2


def test_whitening_direction():
    """A high-variance direction is shrunk relative to a low-variance one."""
    cfg = P.NGConfig(rank=4, update_period=1, num_samples_history=100,
                     alpha=1.0)
    st = P.init_ng_state(D, cfg, "cpu")
    rng = np.random.default_rng(7)
    e0 = np.zeros(D)
    e0[0] = 1.0
    for _ in range(40):
        x = (rng.normal(size=(128, 1)) * 20.0) @ e0[None, :] \
            + rng.normal(size=(128, D)) * 0.5
        st = P.ng_update(st, torch.from_numpy(x.astype(np.float32)), cfg)
    probe = torch.eye(D)[:2]
    g = P.precondition_samples(st, probe, cfg)
    assert abs(float(g[0, 0])) < 0.2 * abs(float(g[1, 1]))
