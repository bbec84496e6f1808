"""Log-domain numerator forward-backward on PyTorch.

Port of `_num_forward_backward` (kaldi_fp16_tpu/chain/numerator.py:38-115).
The supervision FSTs of a batch are padded to B x (S states, A arcs)
(chain/graph.py NumeratorGraphBatch) and the T-step recursions run as
Python loops over the batch-wide arrays.

Per frame, the per-arc values are read from the states with an exact
gather, and summed into states by a segment log-sum-exp with a per-row
max shift whose sum is a product against a stored fp32 one-hot matrix,
not a scatter-add: on CUDA, scatter-adds use float atomics, and the
one-hot product keeps repeated runs bit-identical.  TF32 is off for these
products.  States more than ~87 nats below the row max underflow to
log-zero, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO, NumeratorGraphBatch
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls


def _one_hot(idx: torch.Tensor, num: int) -> torch.Tensor:
    """[B, A] int -> [B, A, num] fp32 one-hot; indices >= num give zero rows."""
    out = torch.zeros(idx.shape + (num + 1,), dtype=torch.float32,
                      device=idx.device)
    out.scatter_(-1, idx.clamp(0, num)[..., None], 1.0)
    return out[..., :num]


@torch.no_grad()
def numerator_forward_backward(graph: NumeratorGraphBatch,
                               nnet_output: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nnet_output [B, T, P] -> (total_logprob [B], posteriors [B, T, P])."""
    with fp32_matmuls():
        return _forward_backward(graph, nnet_output.float())


def _forward_backward(graph, nnet_output):
    B, T, P = nnet_output.shape
    S = graph.num_states
    dev = nnet_output.device

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    arc_src = t(graph.arc_src, torch.long)
    arc_dst = t(graph.arc_dst, torch.long)
    arc_pdf = t(graph.arc_pdf, torch.long)
    arc_logw = t(graph.arc_logw, torch.float32)
    arc_mask = t(graph.arc_mask, torch.float32)
    start = t(graph.start, torch.long)
    final_logw = t(graph.final_logw, torch.float32)
    A = arc_src.shape[1]

    e_src = _one_hot(arc_src, S)                                # [B, A, S]
    e_dst = _one_hot(arc_dst, S)
    # out-of-range pdfs (label > num_pdfs, malformed graphs) are skipped,
    # as the fp64 reference skips them
    mask = (arc_mask > 0) & (arc_pdf >= 0) & (arc_pdf < P)

    # per-arc scores for all frames: [T, B, A]
    pdf_idx = arc_pdf.clamp(0, P - 1)[:, None, :].expand(B, T, A)
    scores = torch.gather(nnet_output, 2, pdf_idx) + arc_logw[:, None, :]
    scores = torch.where(mask[:, None, :], scores, LOG_ZERO)
    scores = scores.transpose(0, 1).contiguous()

    def scatter_lse(vals, e):
        """Segment log-sum-exp of per-arc log values into states [B, S];
        masked and log-zero arcs contribute exactly 0."""
        m = torch.where(mask, vals, LOG_ZERO).amax(dim=1, keepdim=True)
        m = torch.clamp(m, min=-1e28)             # all-dead frame guard
        p = torch.where(mask & (vals > LOG_ZERO), torch.exp(vals - m), 0.0)
        sums = torch.bmm(p[:, None, :], e)[:, 0]
        return torch.where(sums > 0, m + torch.log(sums), LOG_ZERO)

    alpha = torch.full((B, S), LOG_ZERO, dtype=torch.float32, device=dev)
    alpha[torch.arange(B, device=dev), start] = 0.0
    alphas = torch.empty((T, B, S), dtype=torch.float32, device=dev)
    for step in range(T):
        alphas[step] = alpha
        src_alpha = torch.gather(alpha, 1, arc_src)
        vals = torch.where(src_alpha > LOG_ZERO, src_alpha + scores[step],
                           LOG_ZERO)
        alpha = scatter_lse(vals, e_dst)

    total = torch.logsumexp(
        torch.where(final_logw > LOG_ZERO, alpha + final_logw, -torch.inf),
        dim=1)
    total = torch.where(torch.isfinite(total), total, LOG_ZERO)

    beta = torch.where(final_logw > LOG_ZERO, final_logw, LOG_ZERO)
    beta_hist = torch.empty_like(alphas)
    for step in range(T - 1, -1, -1):
        # frame t's posteriors use beta at t+1
        beta_hist[step] = beta
        dst_beta = torch.gather(beta, 1, arc_dst)
        vals = torch.where(dst_beta > LOG_ZERO, dst_beta + scores[step],
                           LOG_ZERO)
        beta = scatter_lse(vals, e_src)

    # bulk arc posteriors over all frames, then one one-hot product into pdfs
    src_alpha = torch.gather(alphas, 2, arc_src[None].expand(T, B, A))
    dst_beta = torch.gather(beta_hist, 2, arc_dst[None].expand(T, B, A))
    lp = torch.where((src_alpha > LOG_ZERO) & (dst_beta > LOG_ZERO),
                     src_alpha + scores + dst_beta - total[None, :, None],
                     -torch.inf)
    lp = torch.clamp(lp, max=0.0)                              # chain.cu:311
    arc_post = torch.where(torch.isfinite(lp), torch.exp(lp), 0.0)
    e_pdf = _one_hot(torch.where(mask, arc_pdf, P), P)          # [B, A, P]
    posteriors = torch.bmm(arc_post.transpose(0, 1), e_pdf)     # [B, T, P]
    ok = total > LOG_ZERO
    posteriors = torch.where(ok[:, None, None], posteriors, 0.0)
    return total, posteriors
