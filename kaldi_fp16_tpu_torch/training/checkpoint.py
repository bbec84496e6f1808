"""Checkpoints of a training run: parameters, BN statistics, optimizer
state (velocities, step count, NG states), loss scale, data position and
the SpecAugment generator's state, in a torch-native format.

Port of kaldi_fp16_tpu/training/checkpoint.py (`DataPosition` :26,
`CheckpointManager` :61-129).  The JAX package writes orbax directories,
which the port cannot read; a JAX run carries across through
`convert.train_state_from_jax`.  Each checkpoint is one file
`<directory>/ckpt_<step>.pt` written by `torch.save` (tensors on the CPU,
NamedTuples as dicts) to a temporary name and renamed into place, so a
run killed mid-save leaves the previous checkpoints intact.  Restores use
`torch.load(weights_only=True)`: no pickled code.

The JAX `rng_key` becomes `DataPosition.rng_state`, the state of the
trainer's SpecAugment `torch.Generator` at save time: with it and the
batches consumed, a resumed run replays the killed one.

Under a data group (parallel/mesh.py) every rank holds the same state:
rank 0 writes the file and prunes, and every rank waits at a barrier
until it is in place; every rank restores the whole state onto its own
device, so a checkpoint written under N ranks restores under M.  On a
mesh with a model axis the sharded parameters and velocities are
gathered whole before rank 0 writes, and cut to each rank's slices on
restore: the file is the same whatever mesh wrote it, and restores on
any other.
"""

from __future__ import annotations

import os
import re
import tempfile
from dataclasses import dataclass
from typing import Optional

import torch

from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    full_train_state, param_shardings, shard_params, shard_state_dict,
)
from kaldi_fp16_tpu_torch.parallel.mesh import mesh_axes

FORMAT = "kaldi_fp16_tpu_torch.checkpoint/1"
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


@dataclass
class DataPosition:
    """Where the input pipeline is (epoch, file index, batches consumed)
    and the SpecAugment generator's state at save time."""
    epoch: int = 0
    file_index: int = 0
    batches_consumed: int = 0
    rng_state: Optional[torch.Tensor] = None   # torch.Generator.get_state()


def _to_cpu(tree):
    """Nested dicts / NamedTuples of tensors -> dicts of CPU tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _like(saved, template, device):
    """Rebuild `saved` (dicts of CPU tensors) in the structure and types of
    `template` (its NamedTuple classes), on `device`."""
    if isinstance(template, torch.Tensor):
        return saved.to(device=device, dtype=template.dtype)
    if hasattr(template, "_asdict"):
        return template.__class__(**{
            k: _like(saved[k], v, device)
            for k, v in template._asdict().items()})
    if isinstance(template, dict):
        if set(saved) != set(template):
            raise ValueError(f"checkpoint keys {sorted(saved)} do not match "
                             f"the run's {sorted(template)}")
        return {k: _like(saved[k], v, device) for k, v in template.items()}
    return saved


class CheckpointManager:
    """Numbered checkpoints in one directory, the newest `max_to_keep`
    retained (0: all).  group: the DataGroup or Mesh of the ranks that
    save and restore together."""

    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.group = group

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, net, opt_state, scale_state,
             data_pos: DataPosition = DataPosition()) -> None:
        """net: the Network (its parameters and BN statistics)."""
        sd, opt_state = full_train_state(net, opt_state, self.group)
        if self.group is not None and self.group.rank != 0:
            self.group.barrier()
            return
        blob = {
            "format": FORMAT,
            "step": int(step),
            "network": _to_cpu(sd),
            "opt_state": _to_cpu(opt_state),
            "scale_state": _to_cpu(scale_state),
            "data_position": {
                "epoch": int(data_pos.epoch),
                "file_index": int(data_pos.file_index),
                "batches_consumed": int(data_pos.batches_consumed),
                "rng_state": (None if data_pos.rng_state is None
                              else data_pos.rng_state.detach().cpu().clone()),
            },
        }
        fd, tmp = tempfile.mkstemp(prefix=".ckpt_", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.unlink(self.path(old))
        if self.group is not None:
            self.group.barrier()

    def close(self) -> None:
        """The JAX manager's close (checkpoint.py:127 there), which waits
        for its writer; `save` here writes synchronously, so nothing is
        pending and a call, or a second one, does nothing."""

    def all_steps(self) -> list:
        """Retained checkpoint steps, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> dict:
        """The raw checkpoint of `step` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        blob = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        if blob.get("format") != FORMAT:
            raise ValueError(f"{self.path(step)}: not a {FORMAT} checkpoint")
        return blob

    def restore(self, step: Optional[int], net, opt_state, scale_state):
        """Load `step` (default: the latest) into `net` in place, and
        rebuild the optimizer and loss-scale states in the structure of
        the given ones, on the network's device.  Returns (opt_state,
        scale_state, step, DataPosition)."""
        blob = self.load(step)
        device = next(net.parameters()).device
        net.load_state_dict(shard_state_dict(blob["network"], net.model,
                                             self.group), strict=True)
        saved = blob["opt_state"]
        model = mesh_axes(self.group).model
        if model is not None:
            saved = dict(saved, velocity=shard_params(
                saved["velocity"],
                param_shardings(net.model, self.group, saved["velocity"]),
                model.rank, model.world))
        pos = blob["data_position"]
        return (_like(saved, opt_state, device),
                _like(blob["scale_state"], scale_state, device),
                blob["step"],
                DataPosition(epoch=pos["epoch"], file_index=pos["file_index"],
                             batches_consumed=pos["batches_consumed"],
                             rng_state=pos["rng_state"]))
