"""traintest: end-to-end training smoke test and loop throughput: the loss
must fall over --steps on synthetic cegs (or --egs-dir).

The twin of tools/traintest.py, on --device (default: the current CUDA
device).  The loop is Trainer.train_epoch over --steps batches (the JAX tool's
shape): batch i + 1's place_batch is issued while step i runs.  The timed window
starts after step 2 (its frames excluded) behind a host read of step 2's
loss, and ends with a device sync.  Throughput counts the host loader,
as in the JAX tool: it is a loop number, not a step time.

  --feats-bf16      casts the features to torch.bfloat16 on the host
  --loader-workers  feeds batches from N ProcessLoader processes
  --den-topology    egs (the egs dir's den.fst) or phone-lm
                    (make_phone_lm_den_fst(--pdfs): 7052 states at 3080)
  --bench-json      one JSON line, `train_audio_sec_per_s_per_chip`

Usage:
  python -m kaldi_fp16_tpu_torch.tools.traintest [--egs-dir DIR]
      [--xconfig F] [--steps 20] [--frames-in 48] [--frames-out 15]
      [--den-topology egs|phone-lm] [--batch 8] [--pdfs 48] [--lr 0.01]
      [--no-grid] [--bench-json] [--feats-bf16] [--loader-workers N]
      [--device cpu]

`main(argv)` returns {"losses", "improved", "frames_per_s",
"audio_sec_per_s", "step_ms", "timed_steps", "den_route", "phase_ms"};
run as a program it exits 1 unless the loss fell.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time

import torch

from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device

DEFAULT_XCONFIG = """\
input name=ivector dim=100
input name=input dim=40
linear-component name=linear1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=256
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim=256 bottleneck-dim=64 time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim=256 bottleneck-dim=64 time-stride=3 bypass-scale=0.66
tdnnf-layer name=tdnnf3 dim=256 bottleneck-dim=64 time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim=64 big-dim=256
output-layer name=output dim={pdfs} include-log-softmax=false
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.traintest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--egs-dir")
    ap.add_argument("--xconfig")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--frames-in", type=int, default=48,
                    help="synthetic chunk length (150 = production scale; "
                         "only used when --egs-dir is not given)")
    ap.add_argument("--frames-out", type=int, default=15)
    ap.add_argument("--den-topology", choices=["egs", "phone-lm"],
                    default="egs",
                    help="egs = den.fst from the egs dir; phone-lm = "
                         "make_phone_lm_den_fst(--pdfs), 7052 states at "
                         "3080 pdfs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--no-grid", action="store_true",
                    help="disable frame-grid subsampling")
    ap.add_argument("--bench-json", action="store_true",
                    help="emit one benchmark JSON line at the end")
    ap.add_argument("--feats-bf16", action="store_true",
                    help="cast features to bfloat16 on the host before "
                         "upload")
    ap.add_argument("--loader-workers", type=int, default=0,
                    help="feed batches from N ProcessLoader processes "
                         "instead of the in-line DataLoader")
    device_arg(ap, "training")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("traintest", args.device)
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.io.dataloader import (
        DataLoader, DataLoaderConfig, ProcessLoader,
    )
    from kaldi_fp16_tpu_torch.io.fst import read_fst_file
    from kaldi_fp16_tpu_torch.models.model import (
        build_model, build_model_from_string,
    )
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
    from kaldi_fp16_tpu_torch.tools.train import den_route
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer

    egs_dir = args.egs_dir
    if egs_dir is None:
        egs_dir = tempfile.mkdtemp(prefix="egs_")
        # one full pass covers the run (a ProcessLoader restart costs a
        # spawned process mid-measurement)
        per_file = args.batch * max(4, args.steps // 2 + 3)
        make_synthetic_egs.main([
            egs_dir, "--files", "2", "--per-file", str(per_file),
            "--pdfs", str(args.pdfs), "--frames-in", str(args.frames_in),
            "--frames-out", str(args.frames_out)])

    model = (build_model(args.xconfig) if args.xconfig else
             build_model_from_string(DEFAULT_XCONFIG.format(pdfs=args.pdfs)))
    print(model.summary())

    if args.den_topology == "phone-lm":
        den_fst = make_phone_lm_den_fst(num_pdfs=args.pdfs)
    else:
        den_fst = read_fst_file(os.path.join(egs_dir, "den.fst"))
    den_graph = DenominatorGraph.from_fst(den_fst, args.pdfs)
    den = DenominatorComputation(den_graph, leaky=1e-5, device=dev)

    config = TrainConfig(learning_rate=args.lr, momentum=0.5,
                         frame_subsampling_factor=3,
                         grid_subsample=not args.no_grid)
    trainer = Trainer(model, den, config, ChainTrainingOpts(), device=dev)

    dl_cfg = DataLoaderConfig(batch_size=args.batch, label_dim=args.pdfs,
                              max_fst_states=64, max_fst_arcs=128)
    pattern = os.path.join(egs_dir, "cegs.*.ark")

    def cast(b):
        if not args.feats_bf16:
            return b
        return dataclasses.replace(
            b, features=torch.from_numpy(b.features).to(torch.bfloat16))

    def batch_stream():
        while True:
            if args.loader_workers > 0:
                pl = ProcessLoader(pattern, dl_cfg,
                                   workers=args.loader_workers, depth=4)
                try:
                    yield from map(cast, pl)
                finally:
                    pl.close()
            else:
                yield from map(cast, DataLoader(pattern, dl_cfg))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Trainer.train_epoch runs the loop (batch i + 1's place_batch is
    # issued while step i runs); the wrappers below time its phases and
    # keep each step's device scalars, read in one transfer at the end
    # (a read per step would block the loop on the device)
    outs = []
    clock = {"frames": 0, "start": None}
    phase = {"next": [0.0, 0], "dispatch": [0.0, 0], "place": [0.0, 0]}

    def add(name, t0, first):
        # the first two steps build and warm up: their phases are left out
        if len(outs) >= first:
            phase[name][0] += time.perf_counter() - t0
            phase[name][1] += 1

    def timed(name, fn, first):
        def run(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            add(name, t0, first)
            return r
        return run

    def step(batch, placed=None):
        out = dispatch(batch, placed=placed)
        outs.append(out)
        if len(outs) == 2:
            # step 2's frames are excluded with its time, and the read
            # fences the backlog out of the timed window
            float(out.loss)
            clock["start"] = time.perf_counter()
        elif len(outs) > 2:
            clock["frames"] += batch.batch_size * batch.num_input_frames
        return out

    def fetched(it):
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            add("next", t0, 2)
            yield batch

    # train_batch(i) and the next() before it run with i steps done,
    # place_batch(i + 1) with i + 1
    dispatch = timed("dispatch", trainer.train_batch, 2)
    trainer.train_batch = step
    trainer.place_batch = timed("place", trainer.place_batch, 3)
    stream = batch_stream()
    try:
        trainer.train_epoch(fetched(itertools.islice(stream, args.steps)))
        sync()
        wall = (time.perf_counter() - clock["start"] if clock["start"]
                else 1.0)
        frames = clock["frames"]
        # the same next() with no step in flight: the in-loop minus this
        # is the loader's contention with the running step
        t0 = time.perf_counter()
        for _ in range(4):
            next(stream)
        idle_next_ms = (time.perf_counter() - t0) / 4 * 1e3
    finally:
        stream.close()
    steps = len(outs)

    vals = torch.stack([torch.stack([o.loss.float(), o.objf_per_frame.float(),
                                     o.ok.all().float()])
                        for o in outs]).tolist()
    losses = []
    for i, (loss, opf, ok) in enumerate(vals):
        losses.append(loss)
        print(f"step {i + 1}: loss={loss:.4f} objf/frame={opf:.4f} "
              f"ok={bool(ok)}")
    fps = frames / wall
    audio_sec_per_s = fps / 100.0
    timed_steps = max(1, steps - 2)
    step_ms = wall / timed_steps * 1e3
    improved = losses[-1] < losses[0]
    route = den_route(trainer.den)
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if improved else 'NOT improved'})")
    print(f"den route: {route}")
    print(f"throughput: {fps:,.0f} frames/s = {audio_sec_per_s:,.1f} "
          f"audio-sec/s/chip ({step_ms:.1f} ms/step over {timed_steps} "
          f"timed steps, incl. host dataloader)")
    phase_ms = None
    if all(n for _, n in phase.values()):
        phase_ms = {k: t / n * 1e3 for k, (t, n) in phase.items()}
        phase_ms["idle_next"] = idle_next_ms
        print(f"host-phase attribution (ms/step, blocking time on the "
              f"dispatch thread): next={phase_ms['next']:.1f} "
              f"dispatch={phase_ms['dispatch']:.1f} "
              f"place={phase_ms['place']:.1f} "
              f"idle-next={idle_next_ms:.1f} "
              f"(in-loop minus idle next = contention with the running "
              f"step)")
    if args.bench_json:
        print(json.dumps({
            "metric": "train_audio_sec_per_s_per_chip",
            "value": audio_sec_per_s,
            "unit": "audio-sec/s",
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "timer": "host clock, loop incl. loader, device synced",
        }))
    return {"losses": losses, "improved": improved, "frames_per_s": fps,
            "audio_sec_per_s": audio_sec_per_s, "step_ms": step_ms,
            "timed_steps": timed_steps, "den_route": route,
            "phase_ms": phase_ms}


if __name__ == "__main__":
    sys.exit(0 if main()["improved"] else 1)
