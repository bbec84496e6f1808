"""Pure-numpy float64 reference implementations of the chain recursions.

These are the correctness anchor for the JAX/Pallas kernels: they follow the
reference CUDA semantics step for step (ref: cpp/cuda/chain.cu for the
log-domain numerator, cpp/cuda/chain_den.cu for the probability-domain
leaky-HMM denominator) but run in float64 with deterministic summation
order, playing the role the real-Kaldi oracle played for the reference
(SURVEY.md §4.3).

Also includes a brute-force path-enumeration oracle for tiny FSTs, which is
independent of any forward-backward code entirely.

Copy of kaldi_fp16_tpu/chain/reference.py (numpy only), so that checks on
a machine without JAX (chip_smoke.py) hold the port to the same oracles;
tests/test_torch_denominator.py holds the two equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph, LOG_ZERO
from kaldi_fp16_tpu_torch.io.sparse import CSR


def _logadd(a: float, b: float) -> float:
    if a <= LOG_ZERO:
        return b
    if b <= LOG_ZERO:
        return a
    m, n = (a, b) if a >= b else (b, a)
    return m + np.log1p(np.exp(n - m))


# ---------------------------------------------------------------------------
# Numerator: log-domain forward-backward over a CSR FST
# ---------------------------------------------------------------------------

def numerator_forward_backward_ref(csr: CSR, nnet_output: np.ndarray
                                   ) -> Tuple[float, np.ndarray]:
    """Log-domain forward-backward (ref: chain.cu:80-323, fixed arc order).

    nnet_output: [T, P] log-likelihood-like scores.  CSR labels are
    1-indexed pdfs; label 0 arcs are skipped.  Weights are log-probs.
    Returns (total_logprob, posteriors [T, P]).
    """
    T, P = nnet_output.shape
    S = csr.num_states
    out = nnet_output.astype(np.float64)
    src = csr.src_states()

    alpha = np.full((T + 1, S), LOG_ZERO)
    alpha[0, csr.start_state] = 0.0
    for t in range(T):
        for a in range(csr.num_arcs):
            pdf = csr.labels[a]
            if pdf <= 0 or pdf > P:
                continue
            s, d = src[a], csr.col_idx[a]
            if alpha[t, s] <= LOG_ZERO:
                continue
            val = alpha[t, s] + out[t, pdf - 1] + csr.weights[a]
            alpha[t + 1, d] = _logadd(alpha[t + 1, d], val)

    beta = np.full((T + 1, S), LOG_ZERO)
    for fs, fw in zip(csr.final_states, csr.final_weights):
        beta[T, fs] = fw
    for t in range(T - 1, -1, -1):
        for a in range(csr.num_arcs):
            pdf = csr.labels[a]
            if pdf <= 0 or pdf > P:
                continue
            s, d = src[a], csr.col_idx[a]
            if beta[t + 1, d] <= LOG_ZERO:
                continue
            val = beta[t + 1, d] + out[t, pdf - 1] + csr.weights[a]
            beta[t, s] = _logadd(beta[t, s], val)

    total = LOG_ZERO
    for fs, fw in zip(csr.final_states, csr.final_weights):
        total = _logadd(total, alpha[T, fs] + fw)

    post = np.zeros((T, P))
    if total > LOG_ZERO:
        for t in range(T):
            for a in range(csr.num_arcs):
                pdf = csr.labels[a]
                if pdf <= 0 or pdf > P:
                    continue
                s, d = src[a], csr.col_idx[a]
                if alpha[t, s] <= LOG_ZERO or beta[t + 1, d] <= LOG_ZERO:
                    continue
                lp = alpha[t, s] + out[t, pdf - 1] + csr.weights[a] + beta[t + 1, d] - total
                lp = min(lp, 0.0)  # clamp like chain.cu:311
                post[t, pdf - 1] += np.exp(lp)
    return float(total), post


def numerator_brute_force(csr: CSR, nnet_output: np.ndarray) -> float:
    """Path enumeration oracle: sum over all T-length paths start->final.

    Exponential; only for tiny FSTs in tests."""
    T, P = nnet_output.shape
    out = nnet_output.astype(np.float64)
    src = csr.src_states()
    arcs_from = {}
    for a in range(csr.num_arcs):
        arcs_from.setdefault(int(src[a]), []).append(a)
    finals = {int(s): float(w) for s, w in zip(csr.final_states, csr.final_weights)}

    total = LOG_ZERO

    def rec(state: int, t: int, logp: float):
        nonlocal total
        if t == T:
            if state in finals:
                total = _logadd(total, logp + finals[state])
            return
        for a in arcs_from.get(state, []):
            pdf = csr.labels[a]
            if pdf <= 0:
                continue
            rec(int(csr.col_idx[a]), t + 1,
                logp + out[t, pdf - 1] + csr.weights[a])

    rec(csr.start_state, 0, 0.0)
    return float(total)


# ---------------------------------------------------------------------------
# Denominator: probability-domain leaky-HMM forward-backward
# ---------------------------------------------------------------------------

def denominator_forward_backward_ref(graph: DenominatorGraph,
                                     nnet_output: np.ndarray,
                                     leaky: float = 1e-5,
                                     compute_grad: bool = True,
                                     ) -> Tuple[float, Optional[np.ndarray]]:
    """Probability-domain leaky-HMM forward-backward
    (ref: chain_den.cu:496-699; all six Kaldi behaviors).

    nnet_output: [T, P].  Returns (log_prob, posteriors [T, P] or None).
    """
    T, P = nnet_output.shape
    S = graph.num_states
    init = graph.initial.astype(np.float64)
    prob = graph.prob.astype(np.float64)
    src, dst, pdf = graph.src, graph.dst, graph.pdf

    # 1. exp(nnet) clamped to [-30, 30]  (ApplyExpLimited)
    x = np.exp(np.clip(nnet_output.astype(np.float64), -30.0, 30.0))

    alpha_sum = np.zeros(T + 1)
    alpha_dash_all = np.zeros((T + 1, S))

    alpha = init.copy()
    alpha_sum[0] = alpha.sum()
    alpha_dash = alpha + alpha_sum[0] * leaky * init
    alpha_dash_all[0] = alpha_dash

    log_correction = 0.0
    for t in range(1, T + 1):
        nxt = np.zeros(S)
        np.add.at(nxt, dst, alpha_dash[src] * prob * x[t - 1, pdf])
        if alpha_sum[t - 1] > 0:
            nxt /= alpha_sum[t - 1]
            log_correction += np.log(alpha_sum[t - 1])
        alpha_sum[t] = nxt.sum()
        alpha_dash = nxt + alpha_sum[t] * leaky * init
        alpha_dash_all[t] = alpha_dash

    total_prob = alpha_dash.sum()
    log_prob = float(np.log(total_prob) + log_correction)

    if not compute_grad:
        return log_prob, None

    # Backward
    grad = np.zeros((T, P))
    beta_dash = np.full(S, 1.0 / total_prob)
    beta = beta_dash + leaky * np.dot(init, beta_dash)
    for t in range(T - 1, -1, -1):
        contrib = beta[dst] * prob * x[t, pdf]
        bd = np.zeros(S)
        np.add.at(bd, src, contrib)
        if alpha_sum[t] > 0:
            bd /= alpha_sum[t]
        # posteriors: alpha'[t][src] * beta[t+1][dst] * tp * x / alpha_sum[t]
        gamma = alpha_dash_all[t][src] * contrib
        if alpha_sum[t] > 0:
            gamma /= alpha_sum[t]
        np.add.at(grad[t], pdf, gamma)
        beta_dash = bd
        beta = beta_dash + leaky * np.dot(init, beta_dash)

    return log_prob, grad


def denominator_brute_force(graph: DenominatorGraph, nnet_output: np.ndarray,
                            leaky: float = 0.0) -> float:
    """Dense matrix-product oracle for the denominator (no rescaling tricks).

    With leaky=0 this is exactly sum over paths of
    init[s0] * prod_t (tp * x[t, pdf]) summed over all end states
    (all states final with weight 1).  Computed with dense [S,S,P]-free
    per-frame transition matmuls in float64.  Only for small graphs.
    """
    T, P = nnet_output.shape
    S = graph.num_states
    x = np.exp(np.clip(nnet_output.astype(np.float64), -30.0, 30.0))
    alpha = graph.initial.astype(np.float64).copy()
    logp = 0.0
    for t in range(T):
        if leaky > 0:
            alpha = alpha + alpha.sum() * leaky * graph.initial.astype(np.float64)
        nxt = np.zeros(S)
        np.add.at(nxt, graph.dst,
                  alpha[graph.src] * graph.prob.astype(np.float64) * x[t, graph.pdf])
        s = nxt.sum()
        logp += np.log(s)
        alpha = nxt / s
    if leaky > 0:
        alpha = alpha + alpha.sum() * leaky * graph.initial.astype(np.float64)
        logp += np.log(alpha.sum())
    return float(logp)
