"""Batches of the step cells, drawn on the device from a run's seed.

Batch k: features 0.3 * N(0, 1) [B, T_in, D] with a +2.0 bump around each
supervision frame in the dimension of its pdf, ivectors N(0, 1) [B, I],
and per sequence a supervision graph drawn as the egs generator draws it
(traffic/egs.py): a linear chain of n_out pdf arcs with one alternative
arc a frame.  Each batch has seeds of its own, so batch k is the same
whatever else the run draws.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic.egs import numerator_arrays
from benchmark.traffic.seeds import sub_seed


def make_batch(seed: int, k: int, B: int, T_in: int, n_out: int, pdfs: int,
               feat_dim: int, ivector_dim: int, left: int, stride: int,
               device) -> dict:
    """{"features", "ivectors", "weights", "deriv_weights", "num" (numpy
    numerator arrays), "left_context"}."""
    rng = np.random.default_rng(sub_seed(seed, f"labels{k}"))
    p = rng.integers(1, pdfs + 1, size=(B, n_out))
    alts = rng.integers(1, pdfs + 1, size=(B, n_out))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              f"feats{k}"))
    feats = torch.randn((B, T_in, feat_dim), generator=gen,
                        device=device) * 0.3
    ivecs = torch.randn((B, ivector_dim), generator=gen, device=device)
    t0 = left + np.arange(n_out) * stride
    b_idx, t_idx, d_idx = [], [], []
    for o in (-1, 0, 1):
        t = t0 + o
        ok = (t >= 0) & (t < T_in)
        b_idx.append(np.repeat(np.arange(B), ok.sum()))
        t_idx.append(np.tile(t[ok], B))
        d_idx.append((p[:, ok] % feat_dim).reshape(-1))
    idx = tuple(torch.as_tensor(np.concatenate(a), device=device)
                for a in (b_idx, t_idx, d_idx))
    feats.index_put_(idx, torch.full((len(idx[0]),), 2.0, device=device),
                     accumulate=True)
    exs = [{"pdfs": p[b], "alts": alts[b]} for b in range(B)]
    return {"features": feats, "ivectors": ivecs,
            "weights": torch.ones(B, device=device),
            "deriv_weights": torch.ones((B, n_out), device=device),
            "num": numerator_arrays(exs, 0, 0, pdfs), "left_context": left}
