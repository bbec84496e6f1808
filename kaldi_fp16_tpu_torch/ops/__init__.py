"""Hand-written CUDA kernels (csrc/*.cu, built by _build.py) and their
plain PyTorch versions; the generic NN ops and losses of the auxiliary
model families (nn.py, losses.py: plain torch ops, as their JAX
counterparts reach no kernel)."""

from kaldi_fp16_tpu_torch.ops.nn import (
    avg_pool1d, conv1d, depthwise_separable_conv1d, dropout, layer_norm,
    max_pool1d, squeeze_excite, stats_pooling,
)
