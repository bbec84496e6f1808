"""LF-MMI "chain" objective on PyTorch: the port of kaldi_fp16_tpu.chain.

  graph.py           denominator graph + padded numerator batches (numpy copy)
  den_layout.py      chain decomposition of the den graph (numpy copy)
  den_structured.py  structured den forward-backward: loop scans with the M
                     products on den_matmul, or the fused den_scan kernels
  denominator.py     DenominatorComputation: structured or blocked layout
  numerator.py       log-domain numerator forward-backward
  objective.py       chain objective as a torch.autograd.Function
"""

import importlib

from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, NumeratorGraphBatch, build_numerator_batch,
)

# the objective's names load on first use: the data path imports
# chain.graph, and a ProcessLoader worker must not pull in torch
# (io/dataloader.py)
_LAZY = {"ChainResult": "objective", "ChainTrainingOpts": "objective",
         "chain_loss_and_grad": "objective", "chain_objf": "objective"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
