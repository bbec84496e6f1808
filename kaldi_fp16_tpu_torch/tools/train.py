"""train: the full training program on PyTorch (ref: scripts/train_cnn_tdnn.sh:
epochs 15, lr 1e-3 -> 1e-4 exponential, batch 64, warmup).

The twin of tools/train.py: trains an xconfig acoustic model on cegs ark
files with the chain objective, checkpointing (training/checkpoint.py),
JSONL metrics, LR scheduling and eval passes, on one device.  It takes
tools/train.py's flags, so configs/train_flagship.sh's flag set parses
unchanged, with these differences:

  --device      where to train (default: the current CUDA device); it
                replaces --cpu (`--device cpu` runs the plain versions)
  --feats-bf16  casts the features to torch.bfloat16 on the host
  --data-parallel N (N != 0) raises: data parallelism is not ported yet
  --den-mode, --bn-lowp   not ported (both revoked in the JAX package)

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
import sys

import numpy as np
import torch


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
                    help="not ported yet: any value but 0 raises")
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
        raise SystemExit("error: --data-parallel is not ported yet "
                         "(ROADMAP queue 1 item 12)")
    with deterministic_cudnn():
        return train(args)


def train(args) -> dict:
    """The training run of parsed flags; see `main`."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.io.dataloader import (
        DataLoader, DataLoaderConfig, PrefetchLoader, ProcessLoader,
    )
    from kaldi_fp16_tpu_torch.io.egs import count_examples
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    from kaldi_fp16_tpu_torch.models.model import build_model
    from kaldi_fp16_tpu_torch.training.checkpoint import (
        CheckpointManager, DataPosition,
    )
    from kaldi_fp16_tpu_torch.training.schedulers import warmup_lr
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer, exponential_lr
    from kaldi_fp16_tpu_torch.utils.metrics import MetricsLogger
    from kaldi_fp16_tpu_torch.utils.profiling import StepTimer

    device = resolve_device(args.device)
    model = build_model(args.xconfig)
    print(model.summary())

    den_fst = read_fst_file(args.den_fst)
    if den_fst is None:
        raise SystemExit(f"error: {args.den_fst}: not a readable OpenFst "
                         f"vector FST")
    print(f"den.fst: {den_fst.num_states} states, {den_fst.num_arcs} arcs")
    den_graph = DenominatorGraph.from_fst(den_fst, args.pdfs)
    den = DenominatorComputation(den_graph, leaky=args.leaky_hmm,
                                 device=device)

    # total steps for the lr schedule from a cheap marker scan (an upper
    # bound: bucketing and invalid examples only flatten the LR tail)
    n_examples = sum(count_examples(f) for f in sorted(globlib.glob(args.egs)))
    n_batches = n_examples // args.batch
    if n_batches == 0:
        sys.exit(f"error: no full batches — fewer than --batch {args.batch} "
                 f"examples in {args.egs!r} ({n_examples} found); lower --batch")
    if args.steps_per_epoch:
        n_batches = min(n_batches, args.steps_per_epoch)
    total_steps = max(n_batches * args.epochs, 1)
    print(f"{n_batches} batches/epoch, {total_steps} total steps")

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
                      seed=args.seed, device=device)

    mgr = (CheckpointManager(args.ckpt_dir,
                             max_to_keep=max(args.ckpt_keep,
                                             args.average_last))
           if args.ckpt_dir else None)
    if args.average_last > 1 and not mgr:
        sys.exit("error: --average-last needs --ckpt-dir")
    metrics = MetricsLogger(args.metrics, echo=False) if args.metrics else None

    def run_valid(tag="valid"):
        """One eval pass over --valid-egs; logs and returns objf/frame."""
        if not args.valid_egs:
            return None
        v_cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs,
                                 shuffle_files=False,
                                 max_fst_states=args.fst_pad_states,
                                 max_fst_arcs=args.fst_pad_arcs)
        res = trainer.eval_epoch(DataLoader(args.valid_egs, v_cfg))
        if res is None:
            print(f"warning: no full batches in --valid-egs "
                  f"{args.valid_egs!r} at --batch {args.batch}")
            return None
        print(f"{tag} objf/frame={res['objf_per_frame']:.4f} "
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
        print(f"resumed from step {trainer.global_step} "
              f"(epoch {pos.epoch}, skipping {skip_batches} "
              f"consumed batches)")

    timer = StepTimer(skip_first=2, device=trainer.device)
    steps_log = []      # per-step scalars, as drained
    readers = set()

    def host_cast(b):
        if b is None or not args.feats_bf16:
            return b
        return dataclasses.replace(
            b, features=torch.from_numpy(b.features).to(torch.bfloat16))

    for epoch in range(start_epoch, args.epochs):
        dl_cfg = DataLoaderConfig(batch_size=args.batch,
                                  label_dim=args.pdfs,
                                  shuffle_files=True,
                                  shuffle_buffer=args.shuffle_buffer,
                                  seed=args.seed + epoch,
                                  max_fst_states=args.fst_pad_states,
                                  max_fst_arcs=args.fst_pad_arcs)
        loader = None
        if args.loader_workers > 0:
            batches = ProcessLoader(args.egs, dl_cfg,
                                    workers=args.loader_workers,
                                    depth=max(1, args.prefetch))
        else:
            loader = DataLoader(args.egs, dl_cfg)
            batches = (PrefetchLoader(loader, args.prefetch) if args.prefetch
                       else loader)
        epoch_objf = []
        # per-step scalars stay on the device and are drained in one
        # transfer per log window
        pending = []   # (global_step, TrainStepOutput, lr)

        def flush():
            if not pending:
                return None
            vals = torch.stack([torch.stack([
                o.loss, o.objf_per_frame, o.num_logprob, o.den_logprob,
                o.grad_norm, o.skipped.float(), o.ok.float()]).float()
                for _, o, _ in pending]).tolist()
            last = None
            for (gstep, _, lr), (loss, opf, num, den_lp, gn, skipped,
                                 ok) in zip(pending, vals):
                last = opf
                epoch_objf.append(last)
                rec = dict(epoch=epoch, loss=loss, objf_per_frame=opf,
                           num=num, den=den_lp, grad_norm=gn, lr=lr,
                           skipped=bool(skipped), ok=bool(ok))
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
            while nxt is not None:
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                batch, cur = nxt, placed
                nxt = host_cast(next(it, None))
                with timer:
                    out = trainer.train_batch(batch, placed=cur)
                placed = (trainer.place_batch(nxt)
                          if nxt is not None else None)
                pending.append((trainer.global_step, out,
                                schedule(trainer.global_step)))
                if (i + 1) % args.log_every == 0:
                    last = flush()
                    print(f"epoch {epoch} step {trainer.global_step}: "
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
        print(f"epoch {epoch}: avg objf/frame = "
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
            print(f"--average-last {args.average_last}: only "
                  f"{len(steps)} checkpoints retained, skipping")
        else:
            final_valid = run_valid("final")
            names = [n for n, _ in trainer.net.named_parameters()]
            nets = [mgr.load(s)["network"] for s in steps]
            sd = trainer.net.state_dict()
            for n in names:
                sd[n] = (sum(s[n] for s in nets) / len(steps)).to(sd[n].dtype)
            trainer.net.load_state_dict(sd)
            print(f"averaged params over checkpoints {steps}")
            avg_valid = run_valid("averaged")
            if (final_valid is not None and avg_valid is not None
                    and avg_valid < final_valid):
                print("note: averaged model scored below the final model "
                      "on valid — keeping the averaged save anyway "
                      "(pick by the metrics log)")
            mgr.save(trainer.global_step + 1, trainer.net,
                     trainer.opt_state, trainer.scale_state,
                     DataPosition(epoch=args.epochs,
                                  rng_state=trainer.rng_state))
            print(f"averaged model saved as step {trainer.global_step + 1}")

    if metrics:
        metrics.close()
    print(f"done: {trainer.global_step} steps, "
          f"final objf/frame {trainer.metrics.objf_per_frame:.4f}")
    return {"trainer": trainer, "timer": timer.summary(),
            "readers": "+".join(sorted(readers)), "steps": steps_log}


if __name__ == "__main__":
    main()
