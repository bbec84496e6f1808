"""train: the full training program on PyTorch (ref: scripts/train_cnn_tdnn.sh:
epochs 15, lr 1e-3 -> 1e-4 exponential, batch 64, warmup).

The twin of tools/train.py: trains an xconfig acoustic model on cegs ark
files with the chain objective, checkpointing (training/checkpoint.py),
JSONL metrics, LR scheduling and eval passes, on one device or, with
--data-parallel, on N ranks.  It takes tools/train.py's flags, so
configs/train_flagship.sh's flag set parses unchanged, with these
differences:

  --device      where to train (default: the current CUDA device); it
                replaces --cpu (`--device cpu` runs the plain versions)
  --feats-bf16  casts the features to torch.bfloat16 on the host
  --data-parallel N   N ranks over torch.distributed (parallel/), one
                per local card over NCCL (-1: every card), or N gloo
                ranks on the CPU with --device cpu; the JAX tool's mesh
                of N devices.  --batch is the global batch and must
                divide by N.  This process is rank 0 and spawns the
                others; each rank reads the same example stream from
                the same seed and trains on its rows of every batch, so
                the run is the single process's run at the same global
                batch.  Under torchrun (env://) each process is one rank
                instead and reads its round-robin share of the files
                (`shard_files`), --batch / N examples per batch.
  --den-mode fast, --bn-lowp   the single-pass bf16 den and the
                low-precision BatchNorm: measurement hooks, off by
                default, as in the JAX tool

Usage:
  python -m kaldi_fp16_tpu_torch.tools.train --egs 'data/cegs.*.ark' \\
      --den-fst data/den.fst --xconfig configs/cnn_tdnn.xconfig --pdfs 3080 \\
      --epochs 15 --batch 64 --lr 1e-3 --lr-final 1e-4 \\
      --ckpt-dir exp/ckpt --metrics exp/metrics.jsonl

`main(argv)` returns a summary dict (the Trainer, the step timer's
summary, the parsers that read the egs, the per-step scalars) for
callers such as chip_smoke.py.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob as globlib
import hashlib
import os
import sys

import numpy as np
import torch

from kaldi_fp16_tpu_torch.tools._common import bn_lowp


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.train")
    ap.add_argument("--egs", required=True)
    ap.add_argument("--den-fst", required=True)
    ap.add_argument("--xconfig", required=True)
    ap.add_argument("--pdfs", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-final", type=float, default=1e-4)
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--max-param-change", type=float, default=2.0)
    ap.add_argument("--l2-regularize", type=float, default=0.0)
    ap.add_argument("--xent-regularize", type=float, default=0.0)
    ap.add_argument("--loss-scaling", action="store_true",
                    help="dynamic loss scaling (65536 init, 2x/2000 growth, "
                         "0.5 backoff)")
    ap.add_argument("--orthonormal-interval", type=int, default=4,
                    help="apply the TDNN-F semi-orthogonal constraint "
                         "every N steps (0 disables)")
    ap.add_argument("--natural-gradient", action="store_true",
                    help="Kaldi NG-SGD: precondition affine grads with "
                         "online low-rank Fisher estimates")
    ap.add_argument("--leaky-hmm", type=float, default=1e-5)
    ap.add_argument("--den-mode", default="exact", choices=["exact", "fast"],
                    help="denominator numerics: exact (the fp32 class, the "
                         "default) or fast (single-pass bf16 products, "
                         "an experimental measurement hook)")
    ap.add_argument("--bn-lowp", action="store_true",
                    help="batchnorm in bf16 with fp32-accumulated stats "
                         "(no fp32 activation upcast); a measurement hook")
    ap.add_argument("--no-grid", action="store_true",
                    help="disable frame-grid subsampling: run the "
                         "grid-eligible (post-CNN) stack at the full "
                         "input frame rate")
    ap.add_argument("--feats-bf16", action="store_true",
                    help="cast features to bfloat16 on the host before "
                         "upload (halves the largest host-to-device copy)")
    ap.add_argument("--frame-subsampling", type=int, default=3)
    ap.add_argument("--shuffle-buffer", type=int, default=1024)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="background prefetch depth (0 = synchronous)")
    ap.add_argument("--loader-workers", type=int, default=0,
                    help="ingestion workers: N>0 = N OS processes "
                         "(ProcessLoader), 0 = single pipeline with "
                         "--prefetch overlap")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="checkpoints retained (size >= --average-last)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--valid-egs",
                    help="held-out cegs glob: per-epoch valid objf/frame "
                         "(compute_prob analog: eval-mode forward, no "
                         "updates)")
    ap.add_argument("--average-last", type=int, default=0,
                    help="after training, average the params of the last "
                         "N checkpoints and save them as the final model")
    ap.add_argument("--metrics")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="cap steps per epoch (0 = full pass)")
    ap.add_argument("--fst-pad-states", type=int, default=256)
    ap.add_argument("--fst-pad-arcs", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="N ranks, one per local card (-1: every card), "
                         "or N gloo ranks with --device cpu; --batch is "
                         "the global batch and must divide by N")
    return ap.parse_args(argv)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms (and no autotuning)
    inside the block, restored after: a run must be bit-identical to a
    repeat of it, and a resumed run to the killed one."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.data_parallel:
        return train_data_parallel(args)
    with deterministic_cudnn(), bn_lowp(args.bn_lowp):
        return train(args)


def rank_devices(args) -> list:
    """The devices of --data-parallel's ranks."""
    from kaldi_fp16_tpu_torch.parallel import mesh
    try:
        return mesh.rank_devices(args.device, args.data_parallel)
    except ValueError as e:
        raise SystemExit(f"error: --data-parallel {args.data_parallel}: "
                         f"{e}") from None


def train_data_parallel(args) -> dict:
    """--data-parallel: rank 0 here, the other ranks spawned (or, under
    torchrun, this process as its rank).  Returns rank 0's summary, with
    `ranks`: the other ranks' steps; raises if the ranks' parameters end
    different."""
    import torch.distributed as dist
    from kaldi_fp16_tpu_torch.parallel.mesh import (
        MeshConfig, initialize_distributed, launched_device, make_mesh,
        spawn_ranks,
    )
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if args.data_parallel > 0 and args.data_parallel != world:
            raise SystemExit(f"error: --data-parallel {args.data_parallel} "
                             f"under a launch of {world} processes")
        if args.batch % world:
            raise SystemExit(f"error: --batch {args.batch} does not divide "
                             f"by {world} ranks")
        device = launched_device(args.device, int(os.environ["RANK"]))
        initialize_distributed(device=device)
        try:
            group = make_mesh(MeshConfig(data=world), device)
            res = _train_rank(group, args, True)
            # the digest's leading 60 bits, their max and -min over ranks
            x = int(res["param_digest"][:15], 16)
            hi, neg_lo = group.all_reduce(torch.tensor(
                [x, -x], dtype=torch.int64, device=group.device),
                dist.ReduceOp.MAX).tolist()
            if hi != -neg_lo:
                raise RuntimeError("the ranks' parameters differ after "
                                   "training")
            return res
        finally:
            dist.destroy_process_group()
    devices = rank_devices(args)
    if args.batch % len(devices):
        raise SystemExit(f"error: --batch {args.batch} does not divide by "
                         f"--data-parallel {len(devices)}")
    res, *others = spawn_ranks(_train_rank, devices, args=(args,),
                               rank0_here=True)
    if any(o["param_digest"] != res["param_digest"] for o in others):
        raise RuntimeError("the ranks' parameters differ after training")
    res["ranks"] = others
    return res


def _train_rank(group, args, file_shards=False):
    """One rank's run: rank 0's full summary, the others' steps and
    parameter digest."""
    with deterministic_cudnn(), bn_lowp(args.bn_lowp):
        res = train(args, group, file_shards)
    if group.rank == 0:
        return res
    return {"steps": res["steps"], "param_digest": res["param_digest"]}


def train(args, group=None, file_shards=False) -> dict:
    """The training run of parsed flags; see `main`.  group: this rank's
    DataGroup (parallel/mesh.py); file_shards: each rank reads its share
    of the files, --batch / world examples per batch."""
    import torch.distributed as dist
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.io.dataloader import (
        DataLoader, DataLoaderConfig, PrefetchLoader, ProcessLoader,
        shard_files,
    )
    from kaldi_fp16_tpu_torch.io.egs import count_examples
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    from kaldi_fp16_tpu_torch.models.model import build_model
    from kaldi_fp16_tpu_torch.parallel.data_parallel import shard_chain_batch
    from kaldi_fp16_tpu_torch.training.checkpoint import (
        CheckpointManager, DataPosition,
    )
    from kaldi_fp16_tpu_torch.training.schedulers import warmup_lr
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer, exponential_lr
    from kaldi_fp16_tpu_torch.utils.metrics import MetricsLogger
    from kaldi_fp16_tpu_torch.utils.profiling import StepTimer

    device = group.device if group else resolve_device(args.device)
    rank, world = (group.rank, group.world) if group else (0, 1)
    # rank 0 logs the run; every rank logs its den route
    print_ = print if rank == 0 else (lambda *a, **k: None)
    model = build_model(args.xconfig)
    print_(model.summary())
    if group:
        print_(f"data parallel: {world} ranks over {group.backend}, "
               f"{args.batch // world} of every {args.batch} sequences per "
               f"rank" + (", files sharded per rank" if file_shards else ""))

    den_fst = read_fst_file(args.den_fst)
    if den_fst is None:
        raise SystemExit(f"error: {args.den_fst}: not a readable OpenFst "
                         f"vector FST")
    print_(f"den.fst: {den_fst.num_states} states, {den_fst.num_arcs} arcs")
    den_graph = DenominatorGraph.from_fst(den_fst, args.pdfs)
    den = DenominatorComputation(den_graph, leaky=args.leaky_hmm,
                                 mode=args.den_mode, device=device)

    # total steps for the lr schedule from a cheap marker scan (an upper
    # bound: bucketing and invalid examples only flatten the LR tail); with
    # file shards, the rank with the fewest examples sets it
    files = sorted(globlib.glob(args.egs))
    batch_size = args.batch // world if file_shards else args.batch
    counts = {f: count_examples(f) for f in files}
    n_examples = min(sum(counts[f] for f in shard_files(files, r, world))
                     for r in range(world)) if file_shards else \
        sum(counts.values())
    n_batches = n_examples // batch_size
    if n_batches == 0:
        sys.exit(f"error: no full batches — fewer than --batch {batch_size} "
                 f"examples in {args.egs!r} ({n_examples} found); lower --batch")
    if args.steps_per_epoch:
        n_batches = min(n_batches, args.steps_per_epoch)
    total_steps = max(n_batches * args.epochs, 1)
    print_(f"{n_batches} batches/epoch, {total_steps} total steps")
    egs = shard_files(files, rank, world) if file_shards else args.egs

    schedule = exponential_lr(args.lr, args.lr_final, total_steps)
    if args.warmup_steps:
        schedule = warmup_lr(schedule, args.warmup_steps)

    config = TrainConfig(learning_rate=args.lr, momentum=args.momentum,
                         max_param_change=args.max_param_change,
                         frame_subsampling_factor=args.frame_subsampling,
                         xent_regularize=args.xent_regularize,
                         natural_gradient=args.natural_gradient,
                         orthonormal_interval=args.orthonormal_interval,
                         use_loss_scaling=args.loss_scaling,
                         grid_subsample=not args.no_grid)
    chain_opts = ChainTrainingOpts(l2_regularize=args.l2_regularize,
                                   leaky_hmm_coefficient=args.leaky_hmm,
                                   xent_regularize=args.xent_regularize)
    trainer = Trainer(model, den, config, chain_opts, lr_schedule=schedule,
                      seed=args.seed, device=device, group=group,
                      shard_batches=not file_shards)

    mgr = (CheckpointManager(args.ckpt_dir,
                             max_to_keep=max(args.ckpt_keep,
                                             args.average_last),
                             group=group)
           if args.ckpt_dir else None)
    if args.average_last > 1 and not mgr:
        sys.exit("error: --average-last needs --ckpt-dir")
    metrics = (MetricsLogger(args.metrics, echo=False)
               if args.metrics and rank == 0 else None)

    def run_valid(tag="valid"):
        """One eval pass over --valid-egs; logs and returns objf/frame."""
        if not args.valid_egs:
            return None
        v_cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs,
                                 shuffle_files=False,
                                 max_fst_states=args.fst_pad_states,
                                 max_fst_arcs=args.fst_pad_arcs)
        batches = DataLoader(args.valid_egs, v_cfg)
        if file_shards:
            # every rank reads the whole held-out set; the Trainer takes
            # its batches as they come, so take this rank's rows here
            batches = (shard_chain_batch(b, group) for b in batches)
        res = trainer.eval_epoch(batches)
        if res is None:
            print_(f"warning: no full batches in --valid-egs "
                   f"{args.valid_egs!r} at --batch {args.batch}")
            return None
        print_(f"{tag} objf/frame={res['objf_per_frame']:.4f} "
              f"num={res['num_logprob']:.4f} den={res['den_logprob']:.4f} "
              f"({res['batches']} batches, {res['frames']:.0f} frames)")
        if metrics:
            metrics.log(trainer.global_step,
                        **{f"{tag}_objf_per_frame": res["objf_per_frame"],
                           f"{tag}_num": res["num_logprob"],
                           f"{tag}_den": res["den_logprob"]})
        return res["objf_per_frame"]

    start_epoch = 0
    skip_batches = 0   # fast-forward count for the first resumed epoch
    if args.resume and mgr and mgr.latest_step() is not None:
        pos = trainer.restore(mgr)
        start_epoch = pos.epoch
        # the epoch's batch order is deterministic (loader seeded with
        # seed + epoch), so skipping the consumed batches resumes on the
        # batch the killed run would have trained on next
        skip_batches = pos.batches_consumed
        print_(f"resumed from step {trainer.global_step} "
              f"(epoch {pos.epoch}, skipping {skip_batches} "
              f"consumed batches)")

    timer = StepTimer(skip_first=2, device=trainer.device)
    steps_log = []      # per-step scalars, as drained
    readers = set()
    routed = False      # each rank logs its den route after its first step

    def ranks_have(nxt):
        """Whether every rank has a next batch: with file shards a rank
        may run out first, and all must stop at the same step.  Their
        batches must share one geometry: BatchNorm weighs every rank's
        rows alike (the JAX package's global arrays need one shape too)."""
        if not file_shards:
            return nxt is not None
        t = -1 if nxt is None else nxt.features.shape[1]
        low, neg_high = group.all_reduce(
            torch.tensor([t, -t], device=device), dist.ReduceOp.MIN).tolist()
        if low >= 0 and low != -neg_high:
            raise ValueError(f"the ranks' batches have {low} to {-neg_high} "
                             f"input frames: a data-parallel step needs one "
                             f"geometry on every rank")
        return low >= 0

    def host_cast(b):
        if b is None or not args.feats_bf16:
            return b
        return dataclasses.replace(
            b, features=torch.from_numpy(b.features).to(torch.bfloat16))

    for epoch in range(start_epoch, args.epochs):
        dl_cfg = DataLoaderConfig(batch_size=batch_size,
                                  label_dim=args.pdfs,
                                  shuffle_files=True,
                                  shuffle_buffer=args.shuffle_buffer,
                                  seed=args.seed + epoch,
                                  max_fst_states=args.fst_pad_states,
                                  max_fst_arcs=args.fst_pad_arcs)
        loader = None
        if args.loader_workers > 0:
            batches = ProcessLoader(egs, dl_cfg,
                                    workers=args.loader_workers,
                                    depth=max(1, args.prefetch))
        else:
            loader = DataLoader(egs, dl_cfg)
            batches = (PrefetchLoader(loader, args.prefetch) if args.prefetch
                       else loader)
        epoch_objf = []
        # per-step scalars stay on the device and are drained in one
        # transfer per log window
        # (global_step, TrainStepOutput, lr, the data group's collectives)
        pending = []

        def flush():
            if not pending:
                return None
            vals = torch.stack([torch.stack([
                o.loss, o.objf_per_frame, o.num_logprob, o.den_logprob,
                o.grad_norm, o.skipped.float(), o.ok.float()]).float()
                for _, o, _, _ in pending]).tolist()
            last = None
            for (gstep, _, lr, calls), (loss, opf, num, den_lp, gn, skipped,
                                        ok) in zip(pending, vals):
                last = opf
                epoch_objf.append(last)
                rec = dict(epoch=epoch, loss=loss, objf_per_frame=opf,
                           num=num, den=den_lp, grad_norm=gn, lr=lr,
                           skipped=bool(skipped), ok=bool(ok))
                if group:
                    rec["collectives"], rec["collective_bytes"] = calls
                steps_log.append(dict(step=gstep, **rec))
                if metrics:
                    metrics.log(gstep, **rec)
            pending.clear()
            return last

        try:
            # pipelined loop: upload batch i+1 while step i runs
            it = iter(batches)
            i = 0
            if epoch == start_epoch and skip_batches:
                for i in range(skip_batches):
                    if next(it, None) is None:
                        break
                i = skip_batches
            nxt = host_cast(next(it, None))
            placed = trainer.place_batch(nxt) if nxt is not None else None
            while ranks_have(nxt):
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                batch, cur = nxt, placed
                nxt = host_cast(next(it, None))
                calls = (group.calls, group.bytes) if group else (0, 0)
                with timer:
                    out = trainer.train_batch(batch, placed=cur)
                if group:
                    calls = (group.calls - calls[0], group.bytes - calls[1])
                if group and not routed:
                    routed = True
                    print(f"rank {rank}/{world} on {device}: "
                          f"{cur[0]['features'].shape[0]} sequences per "
                          f"step, {den_route(trainer.den)}")
                placed = (trainer.place_batch(nxt)
                          if nxt is not None else None)
                pending.append((trainer.global_step, out,
                                schedule(trainer.global_step), calls))
                if (i + 1) % args.log_every == 0:
                    last = flush()
                    print_(f"epoch {epoch} step {trainer.global_step}: "
                          f"objf/frame={last:.4f} "
                          f"lr={schedule(trainer.global_step):.2e}")
                if mgr and trainer.global_step % args.ckpt_every == 0:
                    flush()
                    mgr.save(trainer.global_step, trainer.net,
                             trainer.opt_state, trainer.scale_state,
                             DataPosition(epoch=epoch, batches_consumed=i + 1,
                                          rng_state=trainer.rng_state))
                i += 1
            flush()
        finally:
            if args.loader_workers > 0 or args.prefetch:
                batches.close()   # stop producers on an early break
        if loader is not None and loader.readers:
            readers.update(loader.readers.split("+"))
        print_(f"epoch {epoch}: avg objf/frame = "
              f"{np.mean(epoch_objf) if epoch_objf else float('nan'):.4f}  "
              f"{timer.summary()}  loader: {batches.summary()}")
        run_valid()

    if mgr:
        mgr.save(trainer.global_step, trainer.net, trainer.opt_state,
                 trainer.scale_state,
                 DataPosition(epoch=args.epochs, rng_state=trainer.rng_state))

    if args.average_last > 1 and mgr:
        # Kaldi final-model combination, equal-weight analog: average the
        # parameters of the last N checkpoints (BN statistics and optimizer
        # state stay the final model's)
        steps = mgr.all_steps()[-args.average_last:]
        if len(steps) < 2:
            print_(f"--average-last {args.average_last}: only "
                  f"{len(steps)} checkpoints retained, skipping")
        else:
            final_valid = run_valid("final")
            names = [n for n, _ in trainer.net.named_parameters()]
            nets = [mgr.load(s)["network"] for s in steps]
            sd = trainer.net.state_dict()
            for n in names:
                sd[n] = (sum(s[n] for s in nets) / len(steps)).to(sd[n].dtype)
            trainer.net.load_state_dict(sd)
            print_(f"averaged params over checkpoints {steps}")
            avg_valid = run_valid("averaged")
            if (final_valid is not None and avg_valid is not None
                    and avg_valid < final_valid):
                print_("note: averaged model scored below the final model "
                      "on valid — keeping the averaged save anyway "
                      "(pick by the metrics log)")
            mgr.save(trainer.global_step + 1, trainer.net,
                     trainer.opt_state, trainer.scale_state,
                     DataPosition(epoch=args.epochs,
                                  rng_state=trainer.rng_state))
            print_(f"averaged model saved as step {trainer.global_step + 1}")

    if mgr:
        mgr.close()
    if metrics:
        metrics.close()
    print_(f"done: {trainer.global_step} steps, "
           f"final objf/frame {trainer.metrics.objf_per_frame:.4f}")
    res = {"trainer": trainer, "timer": timer.summary(),
           "readers": "+".join(sorted(readers)), "steps": steps_log}
    if group:
        res["param_digest"] = state_digest(trainer.net.state_dict())
    return res


def state_digest(state_dict) -> str:
    """sha256 of a Network's state_dict (parameters and BN statistics), in
    order."""
    return hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes()
        for t in state_dict.values())).hexdigest()


def den_route(den) -> str:
    """Which den path a rank's last step took: the fused scans need a
    multiple of 128 rows (ops/den_scan.py), a rank with fewer takes the
    loop scans (den_matmul on a card)."""
    if den.layout_used != "structured":
        return f"{den.layout_used} den"
    return f"structured den, {den._structured.scan_used} scans"


if __name__ == "__main__":
    main()
