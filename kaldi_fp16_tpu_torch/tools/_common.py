"""What the verification tools share: the device they check, and the
metrics file a killed training run leaves behind."""

from __future__ import annotations

import json
import os

import torch

from kaldi_fp16_tpu_torch.device import resolve_device


def device_arg(ap, what="the checks"):
    """Add --device to an ArgumentParser."""
    ap.add_argument("--device", default=None,
                    help=f"torch device for {what} (default: the current "
                         f"CUDA device; with no card, pass --device cpu)")


def tool_device(name: str, device) -> torch.device:
    """--device as a torch.device; None is the current CUDA device.  A tool
    that checks the card never carries on on the CPU: with no card and no
    --device, it exits with a message."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{name}: {e}") from None


def read_metrics(path):
    """Rows of a metrics JSONL file; tolerates a torn tail line (a
    killed training run tears its last write)."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows
