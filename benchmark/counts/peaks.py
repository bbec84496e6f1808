"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), copied from kaldi_fp16_tpu_torch/utils/
profiling.py at commit de5aca0.  A run states the card's power limit
beside every share of these peaks."""

H100_PEAK_BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores, FLOP/s
H100_PEAK_HBM_BYTES = 3.35e12     # HBM3, bytes/s
