"""Process groups for data, sequence and tensor parallelism on
torch.distributed.

Port of kaldi_fp16_tpu/parallel/mesh.py (`MeshConfig` :27, `make_mesh`
:34-45, `initialize_distributed` :48-70): one process per rank, each with
its own device, joined by NCCL on cards and by gloo on the CPU.  The
ranks form a data x seq x model mesh laid out as the JAX package's
`grid.reshape(data, seq, model)` (:46-48): rank = (d * seq + s) * model + m.

The JAX package partitions one jitted program and lets GSPMD insert the
collectives; here every rank runs its own program on its share, so each
global reduction of the step is an explicit collective of one axis
(parallel/data_parallel.py):

  data   each rank's rows of the batch: the gradients' sum;
  seq    each rank's frames of the time axis: the halo exchanges of the
         temporal ops and the gather of the outputs before the loss;
  model  each rank's columns of the wide heads: the tensor-parallel
         copies, reductions and gathers;
  dp     data x seq, the ranks that hold different frames of the batch:
         the gradients, BatchNorm's and NG-SGD's statistics and the
         reported sums reduce over it.

A mesh with only a data axis is a `DataGroup` over the whole process
group, as before; `make_mesh` returns a `Mesh` of `DataGroup`s when seq or
model is above 1.  A `DataGroup` runs only all_reduce, broadcast and
barrier, the collectives gloo also runs on CUDA tensors, and counts the
calls and bytes on the host; every gather and halo is an all-reduce of a
zero-filled buffer, one contributor per slot, which is exact.

`rank_devices` gives the ranks of one host their devices (one card each
over NCCL; gloo ranks may share one), `launched_device` a process
launched as one rank its card (LOCAL_RANK, else rank mod the cards).
`spawn_ranks` starts the ranks of one group as processes (the `spawn`
start method) on one host, each given its device, and returns what each
rank's function returned; a rank that fails or dies fails the call, and
the collectives' timeout keeps the survivors from waiting forever.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kaldi_fp16_tpu_torch.device import resolve_device

# how long a collective waits for a peer before it fails (the JAX
# package's `heartbeat_timeout_seconds`)
DEFAULT_TIMEOUT_S = 300


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    seq: int = 1

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model


class DataGroup:
    """One axis of the mesh as this process sees it (the `data` axis of a
    data-only mesh): its rank among `world` ranks, its device, the
    backend, and the collectives it has run (`calls`, `bytes`: host-side
    counts, reset by the caller).  pg: the torch.distributed group (None:
    the default group); ranks: its members' global ranks in group order
    (None: every rank)."""

    def __init__(self, rank: int, world: int, device, backend: str,
                 pg=None, ranks: Optional[Sequence[int]] = None):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.pg = pg
        self.ranks = None if ranks is None else tuple(ranks)
        self.calls = 0
        self.bytes = 0

    def __repr__(self):
        return (f"DataGroup(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world, "seq": 1, "model": 1}

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the ranks; returns t."""
        self._count(t)
        dist.all_reduce(t, op=op, group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from rank `src`; returns t."""
        self._count(t)
        dist.broadcast(t, src=src if self.ranks is None else self.ranks[src],
                       group=self.pg)
        return t

    def barrier(self) -> None:
        self.calls += 1
        dist.barrier(group=self.pg)


class Axes(NamedTuple):
    """The groups of a mesh's axes on this rank; None for an axis of one
    rank (and for no mesh)."""
    data: Optional[DataGroup]
    seq: Optional[DataGroup]
    model: Optional[DataGroup]
    dp: Optional[DataGroup]           # data x seq


NO_AXES = Axes(None, None, None, None)


class Mesh:
    """A data x seq x model mesh (seq or model above 1) as this rank sees
    it: `axes`, the group of each axis this rank belongs to (None for an
    axis of one rank), `coords` (d, s, m), and the whole process group for
    broadcast and barrier.  `calls` / `bytes` sum every group's counts,
    `counts()` gives them per axis."""

    def __init__(self, config: MeshConfig, world: DataGroup, axes: Axes):
        self.config = config
        self.world_group = world
        self.axes = axes
        self.rank, self.world = world.rank, world.world
        self.device, self.backend = world.device, world.backend
        m, s = config.model, config.seq
        self.coords = (self.rank // (s * m), self.rank // m % s,
                       self.rank % m)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.config.data, "seq": self.config.seq,
                "model": self.config.model}

    def groups(self) -> Dict[str, DataGroup]:
        out, seen = {"world": self.world_group}, {id(self.world_group)}
        for name, g in self.axes._asdict().items():
            if g is not None and id(g) not in seen:
                out[name] = g
                seen.add(id(g))
        return out

    def counts(self) -> Dict[str, Dict[str, int]]:
        """{axis: {"calls", "bytes"}} of every distinct group (dp is
        listed only when it is neither the data nor the seq group)."""
        return {k: {"calls": g.calls, "bytes": g.bytes}
                for k, g in self.groups().items()}

    @property
    def calls(self) -> int:
        return sum(g.calls for g in self.groups().values())

    @property
    def bytes(self) -> int:
        return sum(g.bytes for g in self.groups().values())

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self.world_group.broadcast(t, src)

    def barrier(self) -> None:
        self.world_group.barrier()


def mesh_axes(group) -> Axes:
    """The axes of a Mesh, of a DataGroup (its data axis, which is also
    its dp axis) or of None (no axes)."""
    if group is None:
        return NO_AXES
    if isinstance(group, Mesh):
        return group.axes
    return Axes(data=group, seq=None, model=None, dp=group)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None,
                           backend: Optional[str] = None,
                           timeout_seconds: Optional[float] = None
                           ) -> torch.device:
    """Join the default process group: at `init_method`
    ("tcp://host:port") as `rank` of `world_size`, or from the
    environment torchrun sets (init_method None: "env://").  backend
    None: NCCL when `device` is a card, gloo when it is the CPU.  A
    collective that waits longer than `timeout_seconds` for a peer fails.
    Returns the device (the current CUDA device when None)."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(
            seconds=timeout_seconds or DEFAULT_TIMEOUT_S))
    return device


def make_mesh(config: Optional[MeshConfig] = None, device=None):
    """The mesh of the initialised process group (config None: data =
    every rank): a DataGroup over every rank when seq and model are 1,
    else a Mesh whose axis groups every rank creates, in the same order.
    `device`: this rank's device (default: the current CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    config = config or MeshConfig(data=world)
    if config.size != world:
        raise ValueError(f"mesh {config} needs {config.size} ranks, the "
                         f"process group has {world}")
    rank, device = dist.get_rank(), resolve_device(device)
    backend = dist.get_backend()
    whole = DataGroup(rank, world, device, backend)
    if config.seq == 1 and config.model == 1:
        return whole
    shape = (config.data, config.seq, config.model)
    grid = np.arange(world).reshape(shape)
    # each axis: the rank lists that vary it, the other coordinates fixed
    lists = {"data": grid.transpose(1, 2, 0).reshape(-1, shape[0]),
             "seq": grid.transpose(0, 2, 1).reshape(-1, shape[1]),
             "model": grid.reshape(-1, shape[2]),
             "dp": grid.transpose(2, 0, 1).reshape(shape[2], -1)}
    made: Dict[str, Optional[DataGroup]] = {}
    for name in ("data", "seq", "model", "dp"):
        made[name] = None
        if lists[name].shape[1] == 1:
            continue
        if name == "dp" and (config.seq == 1 or config.data == 1):
            made[name] = made["data" if config.seq == 1 else "seq"]
            continue
        for ranks in lists[name].tolist():
            pg = dist.new_group(ranks)
            if rank in ranks:
                made[name] = DataGroup(ranks.index(rank), len(ranks), device,
                                       backend, pg, ranks)
    return Mesh(config, whole, Axes(**made))


def rank_devices(device, n: int, backend: Optional[str] = None) -> list:
    """The devices of n ranks on this host for `device` (None: the
    current CUDA device): n times the CPU, or one card each (n = -1: every
    card; one rank keeps `device`).  Over gloo, ranks may share cards
    (rank r on card r mod cards); NCCL takes one rank per card, so more
    ranks than cards raise ValueError."""
    device = resolve_device(device)
    if device.type != "cuda":
        if n < 0:
            raise ValueError("-1 ranks counts cards; give the number of "
                             "ranks on the CPU")
        return [device] * n
    cards = torch.cuda.device_count()
    n = cards if n < 0 else n
    if n == 1:
        return [device]
    if n > cards and backend != "gloo":
        raise ValueError(f"{n} ranks need {n} cards, {cards} found")
    return [torch.device("cuda", r % cards) for r in range(n)]


def launched_device(device=None, rank: int = 0) -> torch.device:
    """The device of a rank this process was launched as: `device` when
    given, else the card LOCAL_RANK names (torchrun sets it), else card
    `rank` mod the host's cards."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)            # raises when there is no card
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def free_address() -> str:
    """A tcp:// rendezvous address on a free local port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def join_group(address: str, world: int, rank: int, device,
               backend: Optional[str] = None,
               timeout_seconds: Optional[float] = None,
               config: Optional[MeshConfig] = None):
    """initialize_distributed + make_mesh (default: data = world) for a
    rank of a spawned group."""
    device = initialize_distributed(address, world, rank, device, backend,
                                    timeout_seconds)
    return make_mesh(config or MeshConfig(data=world), device)


def _rank_main(fn, rank, world, address, device, backend, timeout_seconds,
               config, args, results):
    """A spawned rank: join the group, run fn(group, *args), put
    (rank, ok, result or traceback) on `results`.  On the CPU each rank
    takes its share of the host's cores."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        group = join_group(address, world, rank, device, backend,
                           timeout_seconds, config)
        out = fn(group, *args)
        dist.destroy_process_group()
    except BaseException:   # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def spawn_ranks(fn: Callable, devices: Sequence, args: tuple = (),
                backend: Optional[str] = None,
                timeout_seconds: Optional[float] = None,
                rank0_here: bool = False,
                join_seconds: Optional[float] = None,
                config: Optional[MeshConfig] = None) -> List:
    """Run fn(group, *args) on len(devices) ranks of one data group (or of
    the mesh `config`), rank r on devices[r]; returns the ranks' results
    in rank order.

    fn and args are pickled to `spawn`ed processes (fn: a module-level
    function), and so are the spawned ranks' results: numpy arrays, not
    torch tensors (a rank exits once it has sent its result, and torch
    passes a tensor as shared memory that must outlive the sender).
    rank0_here: rank 0 runs in this process (its result need not pickle)
    and leaves the process group destroyed.  A rank that
    raises or dies fails the call, and the other ranks are terminated;
    join_seconds bounds the whole call (None: the collectives' timeout
    alone ends a stuck rank)."""
    import multiprocessing as mp
    import queue as queue_mod

    world = len(devices)
    address = free_address()
    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    first = 1 if rank0_here else 0
    procs = {r: ctx.Process(target=_rank_main, args=(
        fn, r, world, address, devices[r], backend, timeout_seconds, config,
        args, results_q)) for r in range(first, world)}
    for p in procs.values():
        p.start()
    deadline = None if join_seconds is None else time.monotonic() + join_seconds
    results = {}
    try:
        if rank0_here:
            group = join_group(address, world, 0, devices[0], backend,
                               timeout_seconds, config)
            try:
                results[0] = fn(group, *args)
            finally:
                dist.destroy_process_group()
        while len(results) < world:
            try:
                rank, ok, payload = results_q.get(timeout=0.5)
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in procs.items()
                        if r not in results and not p.is_alive()}
                if dead:
                    raise RuntimeError(f"ranks died without a result "
                                       f"(exit codes {dead})") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(procs) - set(results))} "
                                       f"still running after {join_seconds} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for r, p in procs.items():
            p.join(timeout=30)
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with {p.exitcode}")
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        results_q.close()
    return [results[r] for r in range(world)]
