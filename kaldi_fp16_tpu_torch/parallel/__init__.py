"""Data, sequence and tensor parallelism on torch.distributed: one
process per rank of a data x seq x model mesh, NCCL on cards, gloo on the
CPU (port of kaldi_fp16_tpu/parallel/)."""

from kaldi_fp16_tpu_torch.parallel.mesh import (
    DataGroup, Mesh, MeshConfig, initialize_distributed, make_mesh,
    spawn_ranks,
)
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    TimeChunks, all_reduce_grads, batch_moments, broadcast_train_state,
    gather_params, param_shardings, shard_batch, shard_chain_batch,
    shard_params, shard_train_state,
)
