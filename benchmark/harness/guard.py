"""The modules a run must not load: JAX and the JAX package.

Names are compared by their top-level package, whole: the port,
`kaldi_fp16_tpu_torch`, begins with the JAX package's name and is allowed.
"""

from __future__ import annotations

import sys

BLOCKED = frozenset({"jax", "jaxlib", "flax", "kaldi_fp16_tpu"})


def blocked_modules(modules=None) -> set:
    """Top-level names in `modules` (default: sys.modules) that are
    blocked."""
    names = sys.modules if modules is None else modules
    return {m.split(".")[0] for m in names} & BLOCKED
