"""kaldi_fp16_tpu_torch — the PyTorch and CUDA port of kaldi_fp16_tpu.

The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and tests/test_torch_*.py run both
on the same numpy inputs.  This package imports torch and never jax, and
nothing of the JAX package: what it needs of a jax-free module there
(the FST classes, the CSR conversion) it carries as its own copy.
Entry points run on the current CUDA device unless given a device
(`device.default_device`); CPU runs pass device="cpu".

  io/        FST data classes and CSR conversion (numpy)
  models/    xconfig -> layers -> nn.Module network (bf16 compute, fp32 masters)
  chain/     LF-MMI objective: numerator, structured and blocked
             denominator, autograd
  ops/       hand-written CUDA kernels (csrc/) with their plain versions
  training/  SGD with max-change, loss scaling, orthonormal constraint, step
  tools/     command-line twins of tools/*.py (chainbench)
  convert.py JAX parameter trees <-> the port's state_dict
"""

__version__ = "0.1.0"
