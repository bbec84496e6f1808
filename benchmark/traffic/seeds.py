"""Independent streams of a run's seed: one integer per named use."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, use: str) -> int:
    """A 63-bit seed for `use` (e.g. "weights", "egs") drawn from the run's
    seed, which may be any non-negative integer."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64,
                                 zlib.crc32(use.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
