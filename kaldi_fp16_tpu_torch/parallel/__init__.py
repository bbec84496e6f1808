"""Data parallelism on torch.distributed: one process per rank, NCCL on
cards, gloo on the CPU (port of kaldi_fp16_tpu/parallel/ over its `data`
axis; `model` and `seq` are not ported)."""

from kaldi_fp16_tpu_torch.parallel.mesh import (
    DataGroup, MeshConfig, initialize_distributed, make_mesh, spawn_ranks,
)
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    all_reduce_grads, batch_moments, broadcast_train_state, shard_batch,
    shard_chain_batch,
)
