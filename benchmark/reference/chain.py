"""Plain float64 reference of the chain (LF-MMI) objective and its derivative.

Written for the benchmark from the semantics of kaldi_fp16_tpu_torch/chain/
reference.py and objective.py at commit de5aca0 (Kaldi's chain_den.cu and
chain.cu): the leaky-HMM denominator forward-backward in the probability
domain with per-frame normalisation, the log-domain numerator
forward-backward, the out-of-range penalty on even frames, L2 on the
output, and per-sequence NaN containment.  Batched over sequences with
index_add_ in float64, so its rounding is far below any of the program's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LOG_ZERO = -1.0e30


@dataclass
class DenGraph:
    """The denominator HMM: arcs (src, dst, pdf, prob) as float64 tensors
    on one device, and the initial probabilities of Kaldi's
    DenominatorGraph::SetInitialProbs (the average of 100 normalised
    propagation steps from the start state)."""
    src: torch.Tensor
    dst: torch.Tensor
    pdf: torch.Tensor
    prob: torch.Tensor
    init: torch.Tensor
    num_states: int

    @classmethod
    def from_arcs(cls, src, dst, pdf, weight, num_states, start, device):
        """Arcs as numpy arrays; weight is the tropical weight (-log prob).
        The probabilities are rounded to float32 first, as a den.fst
        holds them."""
        prob = np.exp(-np.asarray(weight, np.float64)).astype(np.float32)
        prob64 = prob.astype(np.float64)
        cur = np.zeros(num_states)
        cur[start] = 1.0
        avg = np.zeros(num_states)
        for _ in range(100):
            avg += cur / 100.0
            nxt = np.zeros(num_states)
            np.add.at(nxt, dst, cur[src] * prob64)
            total = nxt.sum()
            if total > 0:
                nxt /= total
            cur = nxt
        init = avg.astype(np.float32).astype(np.float64)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(t(src, torch.long), t(dst, torch.long), t(pdf, torch.long),
                   t(prob64, torch.float64), t(init, torch.float64),
                   int(num_states))


def den_forward_backward(g: DenGraph, nnet_output: torch.Tensor,
                         leaky: float):
    """nnet_output [B, T, P] -> (log_prob [B], posteriors [B, T, P]), both
    float64."""
    B, T, P = nnet_output.shape
    x = torch.exp(torch.clamp(nnet_output.double(), -30.0, 30.0))
    init = g.init[None, :]
    S = g.num_states
    alpha = init.expand(B, S)
    asum = [alpha.sum(1)]
    alpha_dash = alpha + asum[0][:, None] * leaky * init
    hist = [alpha_dash]
    log_corr = torch.zeros(B, dtype=torch.float64, device=x.device)
    for t in range(1, T + 1):
        nxt = torch.zeros((B, S), dtype=torch.float64, device=x.device)
        nxt.index_add_(1, g.dst, alpha_dash[:, g.src] * g.prob
                       * x[:, t - 1, g.pdf])
        prev = asum[t - 1]
        pos = prev > 0
        nxt = torch.where(pos[:, None], nxt / torch.where(pos, prev, 1.0)[:, None],
                          nxt)
        log_corr = log_corr + torch.where(pos, torch.log(torch.where(
            pos, prev, 1.0)), 0.0)
        asum.append(nxt.sum(1))
        alpha_dash = nxt + asum[t][:, None] * leaky * init
        hist.append(alpha_dash)
    total = alpha_dash.sum(1)
    log_prob = torch.log(total) + log_corr

    grad = torch.zeros((B, T, P), dtype=torch.float64, device=x.device)
    beta_dash = (1.0 / total)[:, None].expand(B, S)
    beta = beta_dash + leaky * (beta_dash * init).sum(1, keepdim=True)
    for t in range(T - 1, -1, -1):
        contrib = beta[:, g.dst] * g.prob * x[:, t, g.pdf]
        bd = torch.zeros((B, S), dtype=torch.float64, device=x.device)
        bd.index_add_(1, g.src, contrib)
        pos = asum[t] > 0
        div = torch.where(pos, asum[t], 1.0)[:, None]
        bd = torch.where(pos[:, None], bd / div, bd)
        gamma = hist[t][:, g.src] * contrib
        gamma = torch.where(pos[:, None], gamma / div, gamma)
        grad[:, t].index_add_(1, g.pdf, gamma)
        beta = bd + leaky * (bd * init).sum(1, keepdim=True)
    return log_prob, grad


def num_forward_backward(num: dict, nnet_output: torch.Tensor,
                         dtype: torch.dtype = torch.float64):
    """Log-domain numerator over a padded batch of supervision graphs
    (arrays [B, A] arc_src / arc_dst / arc_pdf / arc_logw / arc_mask,
    start [B], final_logw [B, S]) -> (log_prob [B], posteriors [B, T, P]),
    computed in `dtype` (float64; a control passes a lower precision) and
    returned in float64."""
    B, T, P = nnet_output.shape
    dev = nnet_output.device

    def t(name, dtype):
        return torch.as_tensor(np.asarray(num[name]), dtype=dtype, device=dev)
    src, dst, pdf = (t("arc_src", torch.long), t("arc_dst", torch.long),
                     t("arc_pdf", torch.long))
    logw = t("arc_logw", dtype)
    mask = (t("arc_mask", dtype) > 0) & (pdf >= 0) & (pdf < P)
    final = t("final_logw", dtype)
    start = t("start", torch.long)
    S = final.shape[1]
    out = nnet_output.to(dtype)
    rows = torch.arange(B, device=dev)[:, None]

    def lse_into(vals, idx):
        """Log-sum-exp of per-arc values [B, A] into states [B, S]."""
        vals = torch.where(mask & (vals > 0.5 * LOG_ZERO), vals, -torch.inf)
        m = torch.full((B, S), -torch.inf, dtype=dtype, device=dev)
        m = m.scatter_reduce(1, idx, vals, "amax")
        mf = torch.where(torch.isfinite(m), m, 0.0)
        s = torch.zeros((B, S), dtype=dtype, device=dev)
        s.index_put_((rows.expand_as(idx), idx),
                     torch.exp(vals - mf.gather(1, idx)), accumulate=True)
        return torch.where(s > 0, mf + torch.log(s), LOG_ZERO)

    A = pdf.shape[1]
    scores = (torch.gather(out, 2, pdf.clamp(0, P - 1)[:, None, :]
                           .expand(B, T, A)).transpose(0, 1) + logw)
    alpha = torch.full((B, S), LOG_ZERO, dtype=dtype, device=dev)
    alpha[torch.arange(B, device=dev), start] = 0.0
    alphas = []
    for k in range(T):
        alphas.append(alpha)
        alpha = lse_into(alpha.gather(1, src) + scores[k], dst)
    fin = torch.where(final > 0.5 * LOG_ZERO, alpha + final, -torch.inf)
    total = torch.logsumexp(fin, dim=1)
    beta = torch.where(final > 0.5 * LOG_ZERO, final, LOG_ZERO)
    post = torch.zeros((B, T, P), dtype=dtype, device=dev)
    for k in range(T - 1, -1, -1):
        a_src = alphas[k].gather(1, src)
        b_dst = beta.gather(1, dst)
        lp = a_src + scores[k] + b_dst - total[:, None]
        live = mask & (a_src > 0.5 * LOG_ZERO) & (b_dst > 0.5 * LOG_ZERO)
        arc_post = torch.where(live, torch.exp(torch.clamp(lp, max=0.0)), 0.0)
        post[:, k].index_put_((rows.expand_as(pdf), pdf.clamp(0, P - 1)),
                              arc_post, accumulate=True)
        beta = lse_into(b_dst + scores[k], src)
    ok = torch.isfinite(total)
    total = torch.where(ok, total, LOG_ZERO)
    post = torch.where(ok[:, None, None], post, 0.0)
    return total.double(), post.double()


def chain_objective(den: DenGraph, num: dict, nnet_output: torch.Tensor,
                    weights: torch.Tensor, deriv_weights: torch.Tensor,
                    l2: float, oor: float, leaky: float, den_fb=None):
    """(total_objf, deriv d objf / d output, num_post, num_lp, den_lp),
    float64, as Kaldi's ComputeChainObjfAndDeriv.  `den_fb`: another den
    (output -> (log_prob, posteriors)) in place of this one."""
    B, T, P = nnet_output.shape
    out = nnet_output.double()
    w = weights.double()
    if den_fb is None:
        den_lp, den_post = den_forward_backward(den, out, leaky)
    else:
        den_lp, den_post = (v.double() for v in den_fb(out))
    deriv = torch.zeros_like(out)
    if oor > 0:
        even = (torch.arange(T, device=out.device) % 2 == 0)[None, :, None]
        g = torch.where(out < -30.0, (-30.0 - out) * 2.0 * oor, 0.0)
        g = torch.where(out > 30.0, (30.0 - out) * 2.0 * oor, g)
        deriv = torch.where(even, g, 0.0)
    num_lp, num_post = num_forward_backward(num, out)
    deriv = deriv + w[:, None, None] * (num_post - den_post)
    l2_term = torch.zeros((), dtype=torch.float64, device=out.device)
    if l2 > 0:
        deriv = deriv - (w * l2)[:, None, None] * out
        l2_term = -0.5 * torch.sum(w * l2 * torch.sum(out * out, dim=(1, 2)))
    per_seq = w * (num_lp - den_lp)
    ok = (torch.isfinite(per_seq) & (num_lp > 0.5 * LOG_ZERO)
          & (den_lp > 0.5 * LOG_ZERO))
    per_seq = torch.where(ok, per_seq, -10.0 * w * T)
    deriv = torch.where(ok[:, None, None], deriv, 0.0)
    deriv = deriv * deriv_weights.double()[:, :, None]
    return per_seq.sum() + l2_term, deriv, num_post, num_lp, den_lp
