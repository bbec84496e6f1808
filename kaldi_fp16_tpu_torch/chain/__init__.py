"""LF-MMI "chain" objective on PyTorch: the port of kaldi_fp16_tpu.chain.

  graph.py           denominator graph + padded numerator batches (numpy copy)
  den_layout.py      chain decomposition of the den graph (numpy copy)
  den_structured.py  structured den forward-backward; M products on the kernel
  denominator.py     DenominatorComputation (structured layout only)
  numerator.py       log-domain numerator forward-backward
  objective.py       chain objective as a torch.autograd.Function
"""
