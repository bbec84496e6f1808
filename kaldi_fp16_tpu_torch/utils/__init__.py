"""Utilities: low-precision analysis (numpy), profiling and step timing,
JSONL metrics."""

from kaldi_fp16_tpu_torch.utils.lowp import (
    ConversionStats, analyze_conversion, f16_to_f32, f32_to_bf16, f32_to_f16,
)
from kaldi_fp16_tpu_torch.utils.profiling import StepTimer, profile_fn, trace
from kaldi_fp16_tpu_torch.utils.metrics import MetricsLogger
