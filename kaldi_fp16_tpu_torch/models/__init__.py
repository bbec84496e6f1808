"""Acoustic model: xconfig DSL -> layer specs (numpy-free copies of the JAX
package's) -> the PyTorch network (network.py)."""

from kaldi_fp16_tpu_torch.models.xconfig import (
    LayerConfig, parse_xconfig, parse_xconfig_file,
)
from kaldi_fp16_tpu_torch.models.layers import Layer, resolve_layers
from kaldi_fp16_tpu_torch.models.model import (
    Model, build_model, build_model_from_string,
)
from kaldi_fp16_tpu_torch.models.network import Network
