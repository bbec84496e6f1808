"""The chain numerator's forward-backward as one hand-written CUDA kernel.

`numerator_kernel(graph, nnet_output)` launches csrc/numerator.cu on a
padded batch of supervision graphs (chain/graph.py NumeratorGraphBatch)
and a CUDA nnet output [B, T, P]: one block per sequence, the alpha and
beta recursions in the log domain with the plain version's per-frame
row-max shift, every sum in a fixed order.  It returns (total log-prob
[B], pdf posteriors [B, T, P]) as chain/numerator.py's plain version
`_forward_backward` computes them, which is what CPU tensors take
(`chain.numerator.numerator_forward_backward` routes the two and counts
the kernel's launches).  A CUDA tensor never falls back to the plain
version: if the kernel cannot be built or launched, the call raises.

The graph's arrays may lie on the host (numpy) or on the card; arrays
already on the card as int32 / float32 are used as they are, int64 index
arrays get one cast.  The kernel takes graphs of up to MAX_STATES states
and MAX_ARCS arcs a sequence (padded), far above Kaldi's supervision
graphs of 150-224-frame chunks (some hundreds of states, ~1,000 arcs);
`check_inputs` raises past them and on what the kernel does not take.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_fp16_tpu_torch.ops._build import launch

MAX_STATES = 4096        # csrc/numerator.cu MAX_STATES
MAX_ARCS = 4096          # csrc/numerator.cu MAX_ARCS

INDEX_FIELDS = ("arc_src", "arc_dst", "arc_pdf", "start")
_TORCH_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


def _kind(a) -> str:
    """"int", "float" or "other" for a numpy array's or a tensor's dtype."""
    dt = a.dtype
    if isinstance(dt, torch.dtype):
        if dt.is_floating_point:
            return "float"
        return "int" if dt in _TORCH_INTS else "other"
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return "float"
    return "int" if np.issubdtype(dt, np.integer) else "other"


def check_inputs(graph, nnet_output: torch.Tensor):
    """(B, T, P, S, A) of a graph batch and its nnet output; ValueError on
    what the kernel does not take: a wrong rank or dtype, arrays whose B,
    A or S disagree, an empty dimension, or S or A past the limits."""
    if not isinstance(nnet_output, torch.Tensor) or nnet_output.ndim != 3:
        raise ValueError("nnet_output must be a [B, T, P] tensor, got "
                         f"{getattr(nnet_output, 'shape', nnet_output)!r}")
    if not nnet_output.is_floating_point():
        raise ValueError(f"nnet_output must be floating point, got "
                         f"{nnet_output.dtype}")
    B, T, P = nnet_output.shape
    arcs = tuple(graph.arc_src.shape)
    S, A = graph.num_states, arcs[1] if len(arcs) == 2 else -1
    want = {name: (B, A) for name in ("arc_src", "arc_dst", "arc_pdf",
                                      "arc_logw", "arc_mask")}
    want.update(start=(B,), final_logw=(B, S))
    for name, shape in want.items():
        a = getattr(graph, name)
        kind = "int" if name in INDEX_FIELDS else "float"
        if _kind(a) != kind:
            raise ValueError(f"graph.{name} must be {kind}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"graph.{name} must be {list(shape)} (B = "
                             f"{B} from nnet_output, A = {A}, S = {S}), "
                             f"got {list(a.shape)}")
    if min(P, S, A) < 1:
        raise ValueError(f"need P, S and A >= 1, got P = {P}, S = {S}, "
                         f"A = {A}")
    if S > MAX_STATES or A > MAX_ARCS:
        raise ValueError(f"the numerator kernel takes at most {MAX_STATES} "
                         f"states and {MAX_ARCS} arcs a sequence, got S = "
                         f"{S}, A = {A}")
    return B, T, P, S, A


def numerator_kernel(graph, nnet_output: torch.Tensor):
    """(total [B], posteriors [B, T, P]) fp32 from one launch of the
    kernel, for a CUDA nnet_output [B, T, P] (any float dtype: read as
    fp32) and its graph batch."""
    B, T, P, S, A = check_inputs(graph, nnet_output)
    dev = nnet_output.device
    if dev.type != "cuda":
        raise ValueError(f"no numerator kernel for {dev}")
    x = nnet_output.float().contiguous()

    def on(name, dtype):
        return torch.as_tensor(getattr(graph, name), dtype=dtype,
                               device=dev).contiguous()

    ints = [on(name, torch.int32) for name in ("arc_src", "arc_dst",
                                               "arc_pdf")]
    total = torch.empty(B, dtype=torch.float32, device=dev)
    post = torch.zeros((B, T, P), dtype=torch.float32, device=dev)
    if B == 0:
        return total, post
    alpha_hist = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    launch("chain_numerator", dev, x, *ints, on("arc_logw", torch.float32),
           on("arc_mask", torch.float32), on("start", torch.int32),
           on("final_logw", torch.float32), alpha_hist, total, post,
           B, T, P, S, A)
    return total, post
