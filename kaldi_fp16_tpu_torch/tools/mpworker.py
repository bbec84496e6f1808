"""mpworker: one rank of an N-process data-parallel training job.

The twin of tools/mpworker.py.  Each of N processes joins one process
group at --coordinator, reads its round-robin share of the ark files
(`shard_files`), takes --local-batch examples as its rows of the global
batch (the shards in rank order), runs data-parallel train steps
(training/train_step.py with the data group), saves a checkpoint (rank 0
writes, every rank waits), restores it and checks it, and writes a JSON
result.  tests/test_torch_multiprocess.py launches N of these on the
CPU and holds the losses against one process on the concatenated batch.

    python -m kaldi_fp16_tpu_torch.tools.mpworker --coordinator 127.0.0.1:PORT \\
        --nproc 2 --pid 0 --egs 'd/cegs.*.ark' --out out0.json --ckpt d/ckpt

--device: this process's device (default: the card LOCAL_RANK names, else
card --pid mod the host's cards; `--device cpu` for the CPU).  The group
runs over NCCL on cards and gloo on the CPU; `--backend gloo` lets
processes share a card.

--die-at-step K SIGKILLs the process before step K (the survivors must
fail within --heartbeat seconds, not hang); --restore-step S restores
checkpoint S, possibly written under another process count, before
training (an elastic resume).
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import signal
import sys

import numpy as np
import torch

# the case of tests/test_multiprocess.py (MP_XCONFIG, NUM_PDFS, the FST
# padding, the frame geometry), held here: the worker imports nothing
# from the tests
NUM_PDFS = 8
T_IN, T_OUT, STRIDE = 12, 4, 3
FST_PAD_STATES, FST_PAD_ARCS = 16, 40
MP_XCONFIG = f"""\
input name=input dim=16
linear-component name=linear1 dim=32
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=32 bottleneck-dim=16 time-stride=1 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=16 big-dim=32
output-layer name=output dim={NUM_PDFS} include-log-softmax=false
"""
TRAIN = dict(learning_rate=0.01, momentum=0.5, frame_subsampling_factor=STRIDE,
             compute_dtype="float32")


def param_sums(net):
    """Each parameter's float64 sum, in order."""
    return [float(p.detach().double().sum()) for p in net.parameters()]


def param_digest(net):
    """sha256 of the state's bytes (parameters and BN statistics)."""
    from kaldi_fp16_tpu_torch.tools.train import state_digest
    return state_digest(net.state_dict())


def local_batch(files, n):
    """The first n examples of `files`: (batch arrays, numerator graphs)."""
    from kaldi_fp16_tpu_torch.chain.graph import build_numerator_batch
    from kaldi_fp16_tpu_torch.io.egs import read_examples
    from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr
    exs = [e for f in files for e in read_examples(f)][:n]
    if len(exs) != n:
        raise ValueError(f"{len(exs)} examples in {files}, need {n}")
    batch = {"features": torch.from_numpy(
                 np.stack([e.features for e in exs]).astype(np.float32)),
             "weights": torch.tensor([e.supervision.weight for e in exs],
                                     dtype=torch.float32)}
    graph = build_numerator_batch([fst_to_csr(e.supervision.fst)
                                   for e in exs],
                                  max_states=FST_PAD_STATES,
                                  max_arcs=FST_PAD_ARCS)
    return batch, graph


def write_arks(d, num_files: int, per_file: int, seed: int = 100) -> list:
    """`num_files` cegs ark files of `per_file` examples at the worker's
    geometry in directory d: random dim-16 features and a linear
    supervision FST of random pdfs, each example from its own seed."""
    from kaldi_fp16_tpu_torch.io.egs import (
        Example, Index, IoBlock, Supervision, write_ark,
    )
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    paths, k = [], 0
    for fi in range(num_files):
        exs = []
        for _ in range(per_file):
            rng = np.random.default_rng(seed + k)
            feats = rng.normal(size=(T_IN, 16)).astype(np.float32)
            states = [FstState() for _ in range(T_OUT + 1)]
            for t in range(T_OUT):
                states[t].arcs.append(FstArc(
                    int(rng.integers(1, NUM_PDFS + 1)), 0.1, t + 1))
            states[-1].final = 0.0
            sup = Supervision(
                name="output", weight=1.0, num_sequences=1,
                frames_per_seq=T_OUT, label_dim=NUM_PDFS,
                fst=Fst(start=0, states=states),
                indexes=[Index(0, t * STRIDE, 0) for t in range(T_OUT)])
            exs.append(Example(
                key=f"utt-{fi}-{k:03d}",
                inputs=[IoBlock("input", [Index(0, t, 0)
                                          for t in range(T_IN)],
                                feats, "FM")],
                supervision=sup))
            k += 1
        paths.append(os.path.join(str(d), f"cegs.{fi + 1}.ark"))
        write_ark(paths[-1], exs)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.mpworker")
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--egs", required=True, help="ark glob, shared by all")
    ap.add_argument("--out", required=True, help="result JSON path")
    ap.add_argument("--ckpt", required=True, help="checkpoint dir (shared)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:LOCAL_RANK, else "
                         "card --pid mod the cards)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="seconds a collective waits for a peer before it "
                         "fails (default: parallel/mesh.py's)")
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="SIGKILL self before this step")
    ap.add_argument("--restore-step", type=int, default=None,
                    help="restore this checkpoint step before training")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_simple_den_fst,
    )
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.io.dataloader import shard_files
    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.parallel.data_parallel import (
        broadcast_train_state,
    )
    from kaldi_fp16_tpu_torch.parallel.mesh import (
        MeshConfig, initialize_distributed, launched_device, make_mesh,
    )
    from kaldi_fp16_tpu_torch.training.checkpoint import (
        CheckpointManager, DataPosition,
    )
    from kaldi_fp16_tpu_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )

    device = initialize_distributed(
        f"tcp://{args.coordinator}", args.nproc, args.pid,
        device=launched_device(args.device, args.pid), backend=args.backend,
        timeout_seconds=args.heartbeat)
    group = make_mesh(MeshConfig(data=args.nproc), device)

    # --- this rank's file shard -> its rows of the global batch ----------
    files = sorted(globlib.glob(args.egs))
    local_files = shard_files(files, args.pid, args.nproc)
    batch, graph = local_batch(local_files, args.local_batch)
    batch = {k: v.to(device) for k, v in batch.items()}

    # --- model and the data-parallel step --------------------------------
    model = build_model_from_string(MP_XCONFIG)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=9),
        NUM_PDFS), leaky=1e-4, device=device)
    config = TrainConfig(**TRAIN)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, device)
    broadcast_train_state(net, opt, scale, group)
    step = make_train_step(model, net, den, graph, ChainTrainingOpts(),
                           config, num_frames_out=T_OUT, group=group)
    mgr = CheckpointManager(args.ckpt, max_to_keep=0, group=group)

    # --- elastic resume: the checkpoint holds the whole state, so one
    # written under another process count restores here unchanged
    restored_sums = restored_digest = None
    if args.restore_step is not None:
        opt, scale, _, _ = mgr.restore(args.restore_step, net, opt, scale)
        restored_sums, restored_digest = param_sums(net), param_digest(net)

    losses = []
    for i in range(args.steps):
        if args.die_at_step is not None and i == args.die_at_step:
            os.kill(os.getpid(), signal.SIGKILL)    # a hard crash
        opt, scale, out = step(opt, scale, batch)
        losses.append(float(out.loss))

    # --- checkpoint under N ranks, restored and checked -----------------
    save_step = args.steps + (args.restore_step or 0)
    mgr.save(save_step, net, opt, scale,
             DataPosition(epoch=1, batches_consumed=save_step))
    net2, opt2, scale2 = init_train_state(
        model, torch.Generator().manual_seed(1), config, device)
    _, _, got_step, pos = mgr.restore(save_step, net2, opt2, scale2)
    ckpt_ok = (got_step == save_step and pos.batches_consumed == save_step
               and param_digest(net2) == param_digest(net))

    with open(args.out, "w") as f:
        json.dump({"pid": args.pid, "process_count": group.world,
                   "device": str(device), "backend": group.backend,
                   "local_files": [os.path.basename(x) for x in local_files],
                   "losses": losses, "param_sums": param_sums(net),
                   "param_digest": param_digest(net),
                   "restored_param_sums": restored_sums,
                   "restored_digest": restored_digest,
                   "ckpt_ok": bool(ckpt_ok)}, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
