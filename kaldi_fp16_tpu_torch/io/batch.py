"""Batch assembly: cegs examples -> static-shape device-ready arrays.

TPU-first redesign of the reference batching (ref: internal/batch/batch.go +
internal/loader/dataloader.go): instead of a ragged
[total_frames x 40] concatenation with per-sequence frame offsets, examples
are BUCKETED by (input_frames, supervision_frames) so each bucket yields
rectangular arrays [B, T, 40] — the static shapes XLA needs.  The real
dataset has exactly 3 frame sizes {164, 203, 224} (SURVEY.md §5 long-context
note), so bucketing costs nothing.

Per-sequence FramesPerSeq is preserved per bucket (the reference's hard-won
lesson: one value for a mixed batch gives -inf numerators,
dataloader.go:162-171).

Copy of kaldi_fp16_tpu/io/batch.py (the port imports nothing of the
JAX package); tests/test_torch_egs_io.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.chain.graph import NumeratorGraphBatch, build_numerator_batch
from kaldi_fp16_tpu_torch.io.egs import Example
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr


@dataclass
class ChainBatch:
    """One bucketed minibatch, ready for the train step."""
    features: np.ndarray          # [B, T_in, feat_dim] float32
    ivectors: Optional[np.ndarray]  # [B, ivec_dim] float32 or None
    weights: np.ndarray           # [B] supervision weights
    deriv_weights: Optional[np.ndarray]  # [B, frames_per_seq] or None
    num_graph: NumeratorGraphBatch
    frames_per_seq: int           # supervision frames (post-subsampling)
    left_context: int             # input-row offset of supervision frame 0
    keys: List[str]

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def num_input_frames(self) -> int:
        return self.features.shape[1]

    def arrays(self) -> Dict[str, np.ndarray]:
        """The dict consumed by train_step."""
        d = {"features": self.features, "weights": self.weights}
        if self.ivectors is not None:
            d["ivectors"] = self.ivectors
        return d


def example_left_context(ex: Example) -> int:
    """Input-row offset of the first supervised frame.

    input indexes span e.g. t = -31..171+31 while supervision starts at t=0:
    offset = sup.t[0] - input.t[0] (ref: docs/kaldi-egs-format.md t ranges;
    chain_loss.go passes leftContext to SubsampleRows)."""
    inp = ex.input_named("input")
    if inp is None or not inp.indexes or not ex.supervision.indexes:
        return 0
    return ex.supervision.indexes[0].t - inp.indexes[0].t


def bucket_key(ex: Example) -> Tuple[int, int]:
    feats = ex.features
    return (feats.shape[0] if feats is not None else 0,
            ex.supervision.frames_per_seq)


def make_batch(examples: List[Example],
               max_fst_states: int = 0,
               max_fst_arcs: int = 0) -> ChainBatch:
    """Assemble one batch from same-bucket examples."""
    if not examples:
        raise ValueError("empty batch")
    t0 = bucket_key(examples[0])
    for ex in examples[1:]:
        if bucket_key(ex) != t0:
            raise ValueError(f"mixed buckets in batch: {bucket_key(ex)} != {t0}")

    feats = np.stack([ex.features for ex in examples]).astype(np.float32)
    ivecs = None
    if examples[0].ivector is not None:
        ivecs = np.stack([ex.ivector[0] for ex in examples]).astype(np.float32)
    weights = np.asarray([ex.supervision.weight for ex in examples], np.float32)

    fps = examples[0].supervision.frames_per_seq
    dws = None
    if any(ex.supervision.deriv_weights is not None for ex in examples):
        # examples without explicit weights default to all-ones; dropping
        # the whole batch's weights would un-mask frames Kaldi zeroed
        dws = np.stack([
            _fit_length(ex.supervision.deriv_weights, fps)
            if ex.supervision.deriv_weights is not None
            else np.ones(fps, np.float32)
            for ex in examples
        ]).astype(np.float32)

    csrs = [fst_to_csr(ex.supervision.fst) for ex in examples]
    num_graph = build_numerator_batch(csrs, max_states=max_fst_states,
                                      max_arcs=max_fst_arcs)

    return ChainBatch(
        features=feats, ivectors=ivecs, weights=weights, deriv_weights=dws,
        num_graph=num_graph, frames_per_seq=fps,
        left_context=example_left_context(examples[0]),
        keys=[ex.key for ex in examples])


def _fit_length(x: np.ndarray, n: int) -> np.ndarray:
    if len(x) == n:
        return x
    if len(x) > n:
        return x[:n]
    return np.pad(x, (0, n - len(x)), constant_values=1.0)
