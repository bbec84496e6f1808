"""LF-MMI "chain" objective on PyTorch: the port of kaldi_fp16_tpu.chain.

  graph.py           denominator graph + padded numerator batches (numpy copy)
  den_layout.py      chain decomposition of the den graph (numpy copy)
  den_structured.py  structured den forward-backward: loop scans with the M
                     products on den_matmul, or the fused den_scan kernels
  denominator.py     DenominatorComputation: structured or blocked layout
  numerator.py       log-domain numerator forward-backward
  objective.py       chain objective as a torch.autograd.Function
"""
