"""Utilities: low-precision analysis (numpy), profiling and step timing,
host spans, JSONL metrics."""

import importlib

from kaldi_fp16_tpu_torch.utils.lowp import (
    ConversionStats, analyze_conversion, f16_to_f32, f32_to_bf16, f32_to_f16,
)
from kaldi_fp16_tpu_torch.utils.metrics import MetricsLogger

# profiling's names load on first use: the data path imports utils.spans,
# and a ProcessLoader worker must not pull in torch (io/dataloader.py)
_LAZY = {"StepTimer": "profiling", "profile_fn": "profiling",
         "trace": "profiling"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
