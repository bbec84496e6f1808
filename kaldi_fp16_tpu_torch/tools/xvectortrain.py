"""xvectortrain on PyTorch: speaker-ID training of the x-vector family.

The twin of tools/xvectortrain.py: synthetic speaker-discriminative
features (the same numpy `synth_batch`, so from one --seed both tools see
the same batches) -> the x-vector TDNN + stats pooling (models/xvector.py)
-> cross-entropy -> Adam with warmup + StepLR (training/schedulers.py), at
the JAX tool's small recipe.  Asserts that training accuracy improves and
prints the JAX tool's JSON line (`metric: xvector_train_smoke`, ...,
`ok`); exits 0 if ok, else 1.  Only the init differs from the JAX tool's
(a torch.Generator in place of a PRNG key); `main(argv, params=...)`
starts from given parameters (convert.xvector_params_from_jax).

Usage:
  python -m kaldi_fp16_tpu_torch.tools.xvectortrain [--speakers 16]
      [--steps 120] [--batch 32] [--frames 80] [--feat-dim 30] [--lr 2e-3]
      [--warmup 10] [--lr-step 60] [--seed 0] [--device cpu]

Runs on the current CUDA device unless given --device; without a card it
stops.  `main(argv)` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kaldi_fp16_tpu_torch.models.xvector import (
    XVectorConfig, init_xvector, xvector_forward, xvector_loss,
)
from kaldi_fp16_tpu_torch.tools._common import device_arg, tool_device
from kaldi_fp16_tpu_torch.training.schedulers import (
    adam_update, init_adam_state, step_lr, warmup_lr,
)


def synth_batch(rng, centers, batch, frames, feat_dim, noise=1.0):
    """Speaker-colored Gaussian features (tools/xvectortrain.py:26-35): each
    speaker has a fixed mean vector; utterances are that mean + noise."""
    n_spk = centers.shape[0]
    labels = rng.integers(0, n_spk, size=batch)
    feats = (centers[labels][:, None, :]
             + noise * rng.normal(size=(batch, frames, feat_dim)))
    return feats.astype(np.float32), labels.astype(np.int32)


def recipe(feat_dim: int, speakers: int) -> XVectorConfig:
    """The JAX tool's small recipe (tools/xvectortrain.py:54-60)."""
    return XVectorConfig(feat_dim=feat_dim, tdnn_dims=(64, 64, 96),
                         tdnn_contexts=((-2, -1, 0, 1, 2), (-2, 0, 2), (0,)),
                         embed_dim=64, segment_dims=(64, 64),
                         num_speakers=speakers)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--speakers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--feat-dim", type=int, default=30)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--lr-step", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    device_arg(ap, "training")
    return ap.parse_args(argv)


def train_step(cfg, params, opt, feats, labels, lr):
    """One Adam step on the cross-entropy; returns (opt, loss)."""
    loss = xvector_loss(cfg, params, feats, labels)
    grads = torch.autograd.grad(loss, [w for p in params.values()
                                       for w in p.values()])
    it = iter(grads)
    grads = {k: {n: next(it) for n in p} for k, p in params.items()}
    _, opt = adam_update(params, grads, opt, lr)
    return opt, loss.detach()


@torch.no_grad()
def accuracy(cfg, params, feats, labels) -> float:
    _, logits = xvector_forward(cfg, params, feats)
    return float((torch.argmax(logits, dim=-1) == labels).float().mean())


def main(argv=None, params=None) -> dict:
    args = parse_args(argv)
    dev = tool_device("xvectortrain", args.device)
    cfg = recipe(args.feat_dim, args.speakers)
    if params is None:
        params = init_xvector(cfg, torch.Generator().manual_seed(args.seed),
                              dev)
    opt = init_adam_state(params)
    sched = warmup_lr(step_lr(args.lr, args.lr_step, gamma=0.5),
                      args.warmup)

    rng = np.random.default_rng(args.seed)
    centers = 2.0 * rng.normal(size=(args.speakers, args.feat_dim))
    eval_feats, eval_labels = (
        torch.from_numpy(a).to(dev) for a in synth_batch(
            rng, centers, 256, args.frames, args.feat_dim))

    acc0 = accuracy(cfg, params, eval_feats, eval_labels)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        feats, labels = synth_batch(rng, centers, args.batch, args.frames,
                                    args.feat_dim)
        opt, loss = train_step(cfg, params, opt,
                               torch.from_numpy(feats).to(dev),
                               torch.from_numpy(labels).to(dev),
                               float(np.float32(sched(step))))
        losses.append(float(loss))
    wall = time.perf_counter() - t0
    acc1 = accuracy(cfg, params, eval_feats, eval_labels)

    # cap the improvement requirement below 1.0: with few speakers
    # the untrained accuracy can already be ~1/2
    ok = (acc1 > max(min(2.0 * acc0, 0.9), 0.5)
          and losses[-1] < losses[0])
    result = {
        "metric": "xvector_train_smoke",
        "initial_accuracy": round(acc0, 4),
        "final_accuracy": round(acc1, 4),
        "first_loss": round(losses[0], 4),
        "final_loss": round(losses[-1], 4),
        "steps": args.steps, "wall_s": round(wall, 1),
        "ok": bool(ok),
    }
    print(json.dumps(result))
    result["losses"] = losses
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
