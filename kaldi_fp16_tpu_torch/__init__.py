"""kaldi_fp16_tpu_torch — the PyTorch and CUDA port of kaldi_fp16_tpu.

The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and tests/test_torch_*.py run both
on the same numpy inputs.  This package imports torch and never jax, and
nothing of the JAX package: what it needs of a jax-free module there
(the FST classes, the CSR conversion) it carries as its own copy.
Entry points run on the current CUDA device unless given a device
(`device.default_device`); CPU runs pass device="cpu".

  io/        Kaldi binary I/O, FSTs, cegs egs (Python and native parser),
             batches, data loaders (numpy)
  models/    xconfig -> layers -> nn.Module network (bf16 compute, fp32
             masters), natural-gradient sites
  chain/     LF-MMI objective: numerator, structured and blocked
             denominator, autograd
  ops/       hand-written CUDA kernels (csrc/) with their plain versions
  training/  SGD with max-change, loss scaling, orthonormal constraint,
             NG-SGD, train and eval steps, Trainer, checkpoints, schedules
  parallel/  data parallelism on torch.distributed (NCCL on cards, gloo
             on the CPU): process groups, global BatchNorm, gradient and
             NG statistics
  utils/     JSONL metrics, step timing (CUDA events)
  tools/     command-line twins of tools/*.py (train, make_synthetic_egs,
             chainbench, mpworker, ...) and profilers
  convert.py JAX parameter and training-state trees <-> the port's
"""

__version__ = "0.1.0"
