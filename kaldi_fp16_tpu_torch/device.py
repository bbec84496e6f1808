"""Where the port runs when no device is given: the current CUDA device.

Every public constructor and entry point of the port that takes a
`device` resolves `device=None` through `resolve_device`, so a run with
no device argument goes to the card, and a box without one raises
instead of computing on the CPU.  CPU runs (the tests) pass
device="cpu" explicitly.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises RuntimeError if CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or `default_device()` when it is None."""
    return default_device() if device is None else torch.device(device)
