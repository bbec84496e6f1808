"""Chain objective + derivative (ComputeChainObjfAndDeriv) on PyTorch.

Port of kaldi_fp16_tpu/chain/objective.py: `_penalize_out_of_range`
(:59-71), `_chain_core` (:88-154), `make_chain_objf_with_post`
(:188-219) and the functional API, `chain_objf_and_deriv` (:74),
`make_chain_objf` (:161), `chain_objf` (:222) and `chain_loss_and_grad`
(:231).  Per batch:

  1. denominator forward-backward (probability domain, leaky HMM), first
  2. out-of-range penalty: +/-30 limit, scale 2*oor_reg, even frames only
  3. numerator forward-backward (log domain)
  4. deriv = weight * (num_post - den_post) [+ penalty]
  5. L2: deriv -= weight*l2*out; l2_term = -0.5*weight*l2*||out||^2
  6. objf = weight * (num_logprob - den_logprob)
  7. NaN/Inf containment per sequence: zero deriv, objf := -10 * weight * T

The analytic posteriors are the derivative, so the objective is a
`torch.autograd.Function` whose backward returns g * deriv.  Sign
convention: it returns the OBJECTIVE (higher is better); training
minimises loss = -objf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO, NumeratorGraphBatch
from kaldi_fp16_tpu_torch.chain.numerator import numerator_forward_backward
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls


@dataclass(frozen=True)
class ChainTrainingOpts:
    """Kaldi ChainTrainingOptions defaults (ref: backward.go:114-140)."""
    l2_regularize: float = 0.0
    out_of_range_regularize: float = 0.01
    leaky_hmm_coefficient: float = 1e-5
    xent_regularize: float = 0.0


class ChainResult(NamedTuple):
    """Diagnostics (ref: ChainLossBackward, backward.go:147-174)."""
    total_objf: torch.Tensor      # scalar: sum_b w_b * (num_b - den_b) + l2
    l2_term: torch.Tensor         # scalar
    total_weight: torch.Tensor    # scalar: sum_b w_b * T
    num_logprob: torch.Tensor     # [B]
    den_logprob: torch.Tensor     # [B]
    objf_per_frame: torch.Tensor  # scalar
    out_of_range_count: torch.Tensor  # scalar int
    ok: torch.Tensor              # [B] bool — False where containment fired


def penalize_out_of_range(nnet_output: torch.Tensor, oor_reg: float,
                          limit: float = 30.0):
    """Returns (penalty_grad [B,T,P], count). Applied on even frames only."""
    B, T, P = nnet_output.shape
    scale = 2.0 * oor_reg
    even = (torch.arange(T, device=nnet_output.device) % 2 == 0)[None, :, None]
    below = nnet_output < -limit
    above = nnet_output > limit
    g = torch.where(below, (-limit - nnet_output) * scale, 0.0)
    g = torch.where(above, (limit - nnet_output) * scale, g)
    g = torch.where(even, g, 0.0)
    count = (even & (below | above)).sum()
    return g, count


@torch.no_grad()
def chain_core(num_graph: NumeratorGraphBatch,
               den: DenominatorComputation,
               nnet_output: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               deriv_weights: Optional[torch.Tensor] = None,
               opts: ChainTrainingOpts = ChainTrainingOpts(),
               ) -> Tuple[ChainResult, torch.Tensor, torch.Tensor]:
    """Returns (result, deriv = d objf / d nnet_output, num_post)."""
    with fp32_matmuls():
        return _chain_core(num_graph, den, nnet_output.float(), weights,
                           deriv_weights, opts)


def chain_objf_and_deriv(num_graph: NumeratorGraphBatch,
                         den: DenominatorComputation,
                         nnet_output: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         deriv_weights: Optional[torch.Tensor] = None,
                         opts: ChainTrainingOpts = ChainTrainingOpts(),
                         ) -> Tuple[ChainResult, torch.Tensor]:
    """Kaldi's ComputeChainObjfAndDeriv: (result, deriv = d objf / d
    nnet_output)."""
    result, deriv, _ = chain_core(num_graph, den, nnet_output, weights,
                                  deriv_weights, opts)
    return result, deriv


def _chain_core(num_graph, den, nnet_output, weights, deriv_weights, opts):
    B, T, P = nnet_output.shape
    w = (torch.ones(B, dtype=nnet_output.dtype, device=nnet_output.device)
         if weights is None else weights.float())

    # 1. denominator first (ref: "Kaldi does denominator FIRST", backward.go)
    den_logprob, den_post = den.forward_backward(nnet_output)

    # 2. out-of-range penalty
    if opts.out_of_range_regularize > 0:
        oor_grad, oor_count = penalize_out_of_range(
            nnet_output, opts.out_of_range_regularize)
    else:
        oor_grad = torch.zeros_like(nnet_output)
        oor_count = torch.zeros((), dtype=torch.int64,
                                device=nnet_output.device)

    # 3. numerator
    num_logprob, num_post = numerator_forward_backward(num_graph, nnet_output)

    # 4. combine
    deriv = oor_grad + w[:, None, None] * (num_post - den_post)

    # 5. L2
    if opts.l2_regularize > 0:
        l2_scale = w * opts.l2_regularize
        deriv = deriv - l2_scale[:, None, None] * nnet_output
        l2_term = -0.5 * torch.sum(
            l2_scale * torch.sum(nnet_output * nnet_output, dim=(1, 2)))
    else:
        l2_term = torch.zeros((), dtype=nnet_output.dtype,
                              device=nnet_output.device)

    # 6. objective
    per_seq_objf = w * (num_logprob - den_logprob)

    # 7. NaN/Inf containment per sequence (ref: backward.go:359-364).  A
    # numerator total of LOG_ZERO (unreachable final state) is a failure
    # too, though -1e30 is finite.
    ok = (torch.isfinite(per_seq_objf)
          & (num_logprob > 0.5 * LOG_ZERO)
          & (den_logprob > 0.5 * LOG_ZERO))
    per_seq_objf = torch.where(ok, per_seq_objf, -10.0 * w * T)
    deriv = torch.where(ok[:, None, None], deriv, 0.0)
    deriv = torch.where(torch.isfinite(deriv), deriv, 0.0)

    if deriv_weights is not None:
        deriv = deriv * deriv_weights[:, :, None]

    total_objf = per_seq_objf.sum() + l2_term
    total_weight = torch.sum(w) * T
    result = ChainResult(
        total_objf=total_objf,
        l2_term=l2_term,
        total_weight=total_weight,
        num_logprob=num_logprob,
        den_logprob=den_logprob,
        objf_per_frame=total_objf / total_weight,
        out_of_range_count=oor_count,
        ok=ok,
    )
    return result, deriv, num_post


class ChainObjf(torch.autograd.Function):
    """objf(nnet_output) with the analytic forward-backward derivative.

    apply(nnet_output, weights, deriv_weights, num_graph, den, opts) ->
    (total_objf, num_post, l2_term, total_weight, num_logprob, den_logprob,
    out_of_range_count, ok).  Only total_objf is differentiable (wrt
    nnet_output); weights and deriv_weights get no gradient.
    """

    @staticmethod
    def forward(ctx, nnet_output, weights, deriv_weights, num_graph, den,
                opts):
        result, deriv, num_post = chain_core(num_graph, den, nnet_output,
                                             weights, deriv_weights, opts)
        ctx.save_for_backward(deriv)
        rest = (num_post, result.l2_term, result.total_weight,
                result.num_logprob, result.den_logprob,
                result.out_of_range_count, result.ok)
        ctx.mark_non_differentiable(*rest)
        return (result.total_objf,) + rest

    @staticmethod
    def backward(ctx, g_objf, *_):
        (deriv,) = ctx.saved_tensors
        return g_objf * deriv, None, None, None, None, None


def _result(objf, l2_term, total_weight, num_lp, den_lp, oor_count, ok):
    return ChainResult(
        total_objf=objf.detach(), l2_term=l2_term, total_weight=total_weight,
        num_logprob=num_lp, den_logprob=den_lp,
        objf_per_frame=objf.detach() / total_weight,
        out_of_range_count=oor_count, ok=ok)


def make_chain_objf(num_graph: NumeratorGraphBatch,
                    den: DenominatorComputation,
                    opts: ChainTrainingOpts = ChainTrainingOpts()):
    """objf_fn(nnet_output, weights) -> (total_objf, ChainResult).

    total_objf backpropagates the analytic derivative into nnet_output;
    weights get no gradient (the JAX custom_vjp's None)."""

    def objf_fn(nnet_output, weights):
        objf, _, *rest = ChainObjf.apply(nnet_output, weights, None,
                                         num_graph, den, opts)
        return objf, _result(objf, *rest)

    return objf_fn


def chain_objf(num_graph, den, nnet_output, weights=None,
               opts: ChainTrainingOpts = ChainTrainingOpts()):
    """One-shot differentiable objective: (total_objf, ChainResult), with
    weights of ones where none are given."""
    if weights is None:
        weights = torch.ones(nnet_output.shape[0], dtype=nnet_output.dtype,
                             device=nnet_output.device)
    return make_chain_objf(num_graph, den, opts)(nnet_output, weights)


def chain_loss_and_grad(num_graph, den, nnet_output, weights=None,
                        opts: ChainTrainingOpts = ChainTrainingOpts()):
    """(loss, ChainResult, d loss / d nnet_output) with loss = -objf."""
    result, deriv = chain_objf_and_deriv(num_graph, den, nnet_output,
                                         weights, opts=opts)
    return -result.total_objf, result, -deriv


def make_chain_objf_with_post(num_graph: NumeratorGraphBatch,
                              den: DenominatorComputation,
                              opts: ChainTrainingOpts = ChainTrainingOpts()):
    """objf_fn(nnet_output, weights, deriv_weights) ->
    (total_objf, ChainResult, num_post).

    total_objf backpropagates the chain derivative into nnet_output; the
    numerator posteriors come back detached, for the cross-entropy head:
    xent_objf = sum(w * num_post * xent_logprob).  deriv_weights [B, T] (or
    None) mask the chain DERIVATIVE per frame; the objective value itself
    is unweighted, as in Kaldi."""

    def objf_fn(nnet_output, weights, deriv_weights):
        objf, num_post, *rest = ChainObjf.apply(
            nnet_output, weights, deriv_weights, num_graph, den, opts)
        return objf, _result(objf, *rest), num_post

    return objf_fn
