"""Synthetic chain examples (cegs) for the recipe cells.

The arithmetic of `make_example` of kaldi_fp16_tpu_torch/tools/
make_synthetic_egs.py at commit de5aca0, frozen here, returning arrays:
features 0.3 * N(0, 1) with a +2.0 bump around each supervision frame in
the dimension of its pdf (so the network has something to learn), one
ivector, and a supervision graph that is a linear chain of frames_out arcs
(the pdf, weight 0) with one alternative arc a frame (another pdf, tropical
weight 2.0) where it differs.  Example i of a seed is the same whatever
else the run draws.
"""

from __future__ import annotations

import numpy as np

ALT_WEIGHT = 2.0      # tropical weight of the alternative arcs


def make_examples(seed: int, count: int, frames_in: int, frames_out: int,
                  pdfs: int, feat_dim: int, ivector_dim: int,
                  left: int = 3) -> list:
    """`count` examples as dicts: key, features [frames_in, feat_dim],
    ivector [1, ivector_dim], pdfs [frames_out] and alts [frames_out]
    (1-based), left (the input row of supervision frame 0), stride."""
    stride = frames_in // frames_out
    need = left + (frames_out - 1) * stride + 1
    if frames_in < need:
        raise ValueError(f"frames_in {frames_in} < {need} for left={left}, "
                         f"frames_out={frames_out}, stride={stride}")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        p = rng.integers(1, pdfs + 1, size=frames_out)
        feats = (rng.normal(size=(frames_in, feat_dim)).astype(np.float32)
                 * 0.3)
        for j, pdf in enumerate(p):
            t0 = left + j * stride
            feats[max(0, t0 - 1): t0 + 2, int(pdf) % feat_dim] += 2.0
        alts = np.asarray([int(rng.integers(1, pdfs + 1)) for _ in p],
                          np.int64)
        ivec = rng.normal(size=(1, ivector_dim)).astype(np.float32)
        out.append({"key": f"utt-{i:05d}", "features": feats, "ivector": ivec,
                    "pdfs": p.astype(np.int64), "alts": alts, "left": left,
                    "stride": stride})
    return out


def numerator_arrays(examples: list, max_states: int, max_arcs: int,
                     pdfs: int) -> dict:
    """The padded numerator batch of the examples' supervision graphs
    (log-domain, 0-based pdfs), as the chain objective reads it: arcs in
    state order, the pdf arc first, padding masked."""
    B = len(examples)
    n = len(examples[0]["pdfs"])
    S = max(max_states, n + 1)
    A = max(max_arcs, 2 * n, 1)
    arc_src = np.zeros((B, A), np.int64)
    arc_dst = np.zeros((B, A), np.int64)
    arc_pdf = np.zeros((B, A), np.int64)
    arc_logw = np.zeros((B, A), np.float64)
    arc_mask = np.zeros((B, A), np.float64)
    final = np.full((B, S), -1.0e30)
    for b, ex in enumerate(examples):
        k = 0
        for i, (p, alt) in enumerate(zip(ex["pdfs"], ex["alts"])):
            arc_src[b, k], arc_dst[b, k], arc_pdf[b, k] = i, i + 1, p - 1
            arc_mask[b, k] = 1.0
            k += 1
            if alt != p:
                arc_src[b, k], arc_dst[b, k], arc_pdf[b, k] = i, i + 1, alt - 1
                arc_logw[b, k] = -ALT_WEIGHT
                arc_mask[b, k] = 1.0
                k += 1
        final[b, n] = 0.0
    return {"arc_src": arc_src, "arc_dst": arc_dst, "arc_pdf": arc_pdf,
            "arc_logw": arc_logw, "arc_mask": arc_mask,
            "start": np.zeros(B, np.int64), "final_logw": final}
