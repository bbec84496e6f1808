"""Work of the structured chain denominator's scans (Kaldi's leaky-HMM
forward-backward on a phone LM of F chains of L states, N sequences, T
frames), as the algorithm needs it.

Per frame each scan applies the dense [F, F] phone-LM transition to N
vectors (2 F^2 N FLOPs) and updates L x F x N states.  Bytes: each input
read once (the float32 M, the emissions: L self-loop, L - 1 forward and one
re-entry factor per chain, sequence and frame) and each output written once
(the [T, L, F, N] history and the per-frame sums).  The split into bf16
products, the chain padding and the launches are the implementation's and
are not counted.
"""

from __future__ import annotations

from benchmark.counts.peaks import H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BYTES


def scan_work(F: int, L: int, N: int, T: int) -> dict:
    """{"flops", "bytes", "bound_s", "bound_by"} of one scan (forward or
    backward: the two have the same shapes)."""
    flops = T * (2.0 * F * F * N + 4.0 * L * F * N)
    emissions = T * (2 * L) * F * N * 4
    history = T * L * F * N * 4
    m = F * F * 4
    stats = T * N * 2 * 4
    nbytes = float(m + emissions + history + stats)
    t_flops = flops / H100_PEAK_BF16_FLOPS
    t_bytes = nbytes / H100_PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_flops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_flops else "compute"}


def den_flops(F: int, L: int, N: int, T: int, S: int, P: int) -> float:
    """FLOPs of one denominator forward-backward: the two scans and the
    posteriors (a product of alpha and beta per state and frame, summed
    into the P pdfs)."""
    return 2 * scan_work(F, L, N, T)["flops"] + T * N * (2.0 * S + P)
