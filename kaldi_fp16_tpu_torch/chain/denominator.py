"""Probability-domain leaky-HMM denominator forward-backward on PyTorch.

Port of `DenominatorComputation` (kaldi_fp16_tpu/chain/denominator.py:122-174),
structured layout only: a den graph that decomposes into HMM chains plus a
dense phone-LM matrix (every real den.fst, and `make_phone_lm_den_fst`)
runs chain/den_structured.py.  The generic blocked layout, for graphs
that do not decompose, is not ported yet: such a graph raises
NotImplementedError rather than falling back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph


class DenominatorComputation:
    """Device-resident denominator graph with forward / forward-backward
    (batched over sequences), as in the JAX package.

    matmul_impl: "kernel" (the CUDA den_matmul kernel for the in-scan M
    products) or "plain" (torch.matmul throughout, for comparisons).
    """

    def __init__(self, graph: DenominatorGraph, leaky: float = 1e-5,
                 hoist_bytes: int = 1 << 30, matmul_impl: str = "kernel",
                 device=None):
        self.leaky = leaky
        lay = analyze_chain_structure(graph)
        if lay is None:
            raise NotImplementedError(
                "this den graph does not decompose into chains (multiple "
                "self-loops, pdf conflicts, or too many chains); the blocked "
                "layout it needs is not ported to PyTorch yet")
        self._structured = StructuredKernels(lay, leaky, hoist_bytes,
                                             matmul_impl=matmul_impl,
                                             device=device)

    def forward(self, nnet_output: torch.Tensor) -> torch.Tensor:
        logp, _ = self._structured.forward_backward(nnet_output,
                                                    compute_grad=False)
        return logp

    def forward_backward(self, nnet_output: torch.Tensor
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """nnet_output [N, T, P] -> (log_prob [N], posteriors [N, T, P])."""
        return self._structured.forward_backward(nnet_output,
                                                 compute_grad=True)
