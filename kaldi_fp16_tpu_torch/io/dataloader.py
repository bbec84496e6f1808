"""DataLoader: multi-file cegs iteration -> validated, bucketed minibatches.

(ref: internal/loader/{loader,dataloader}.go — glob + auto file advance,
shuffle, invalid-example skipping with reasons, stats; redesigned around
bucketed static shapes and multi-host sharding.)

Multi-host: `shard_files` splits the ark file list across processes so
each feeds its own batch shard.

Copy of kaldi_fp16_tpu/io/dataloader.py (numpy only: it never imports
torch, so ProcessLoader's spawned workers never touch CUDA).  Example
order, shuffling and bucketing use the same `random.Random` seeds, so
for one seed the port's batches equal the JAX loader's
(tests/test_torch_dataloader.py).  `DataLoader.readers` says
which parser ran ("native" or "python", io/native.py).
"""

from __future__ import annotations

import glob as globlib
import queue
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.io.batch import ChainBatch, bucket_key, make_batch
from kaldi_fp16_tpu_torch.io.egs import EgsReader, Example
from kaldi_fp16_tpu_torch.utils.spans import span


@dataclass
class LoaderStats:
    examples_read: int = 0
    examples_skipped: int = 0
    batches: int = 0
    files_done: int = 0
    skip_reasons: Dict[str, int] = field(default_factory=dict)
    read_seconds: float = 0.0

    def note_skip(self, reason: str) -> None:
        self.examples_skipped += 1
        key = reason.split("!")[0][:40]
        self.skip_reasons[key] = self.skip_reasons.get(key, 0) + 1


@dataclass
class DataLoaderConfig:
    batch_size: int = 8
    shuffle_files: bool = False
    shuffle_buffer: int = 0          # 0 = no example-level shuffle
    seed: int = 0
    feat_dim: int = 40
    ivector_dim: int = 100
    label_dim: int = 0               # 0 = don't check
    max_fst_states: int = 0          # pad targets (0 = per-batch max)
    max_fst_arcs: int = 0
    drop_remainder: bool = True


def shard_files(files: List[str], process_index: int, process_count: int
                ) -> List[str]:
    """Round-robin file split across hosts."""
    return [f for i, f in enumerate(files) if i % process_count == process_index]


class EgsIterator:
    """Stream examples across multiple ark files with auto-advance
    (ref: loader.go:22-127).  Uses the native C++ parser when built
    (io/native.py), falling back to the pure-Python reader."""

    def __init__(self, pattern_or_files, shuffle: bool = False, seed: int = 0,
                 use_native: bool = True):
        if isinstance(pattern_or_files, str):
            files = sorted(globlib.glob(pattern_or_files))
        else:
            files = list(pattern_or_files)
        if not files:
            raise FileNotFoundError(f"no ark files match {pattern_or_files!r}")
        self.read_errors = 0
        if shuffle:
            rng = random.Random(seed)
            files = files[:]
            rng.shuffle(files)
        self.files = files
        self.use_native = use_native
        self._file_idx = 0
        self._reader: Optional[EgsReader] = None
        self.files_done = 0
        self.readers_used: set = set()   # reader_kind of each file opened

    def _open(self, path: str):
        if self.use_native:
            from kaldi_fp16_tpu_torch.io.native import best_reader, reader_kind
            reader = best_reader(path)
            self.readers_used.add(reader_kind(reader))
            return reader
        self.readers_used.add("python")
        return EgsReader(path)

    def __iter__(self) -> Iterator[Example]:
        return self

    def __next__(self) -> Example:
        while True:
            if self._reader is None:
                if self._file_idx >= len(self.files):
                    raise StopIteration
                try:
                    self._reader = self._open(self.files[self._file_idx])
                except (OSError, ValueError, RuntimeError):
                    self._file_idx += 1  # skip unreadable files (ref: loader.go)
                    continue
            try:
                ex = self._reader.read_example()
            except (EOFError, ValueError) as e:
                # a malformed example aborts the REST of this file — make
                # that loud instead of silently losing the tail
                self.read_errors += 1
                import sys
                print(f"warning: abandoning {self.files[self._file_idx]!r} "
                      f"mid-file after parse error: {e}", file=sys.stderr)
                ex = None
            if ex is not None:
                return ex
            self._reader.close()
            self._reader = None
            self._file_idx += 1
            self.files_done += 1

    def reset(self) -> None:
        if self._reader is not None:
            self._reader.close()
        self._reader = None
        self._file_idx = 0
        self.files_done = 0


class DataLoader:
    """Validated, bucketed batches over cegs ark files
    (ref: dataloader.go:63-277)."""

    def __init__(self, pattern_or_files,
                 config: DataLoaderConfig = DataLoaderConfig(),
                 use_native: bool = True):
        self.config = config
        self.iterator = EgsIterator(pattern_or_files,
                                    shuffle=config.shuffle_files,
                                    seed=config.seed,
                                    use_native=use_native)
        self.stats = LoaderStats()
        self._pending: Dict[Tuple[int, int], List[Example]] = {}
        self._shuffle_rng = random.Random(config.seed + 1)
        self._buffer: List[Example] = []

    # -- example intake -----------------------------------------------------

    def _validated_examples(self) -> Iterator[Example]:
        cfg = self.config
        for ex in self.iterator:
            self.stats.examples_read += 1
            ok, reason = ex.validate(feat_dim=cfg.feat_dim,
                                     ivector_dim=cfg.ivector_dim,
                                     label_dim=cfg.label_dim)
            if not ok:
                self.stats.note_skip(reason)
                continue
            yield ex

    def _shuffled(self) -> Iterator[Example]:
        n = self.config.shuffle_buffer
        if n <= 0:
            yield from self._validated_examples()
            return
        it = self._validated_examples()
        buf = self._buffer
        for ex in it:
            buf.append(ex)
            if len(buf) >= n:
                idx = self._shuffle_rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        self._shuffle_rng.shuffle(buf)
        while buf:
            yield buf.pop()

    # -- batching -----------------------------------------------------------

    def __iter__(self) -> Iterator[ChainBatch]:
        """The batches, each made inside the host span `loader.batch`
        (utils/spans.py), from the previous batch's hand-off through this
        one's assembly; the epoch's end takes one more.  The spans' time
        is `stats.read_seconds`."""
        batches = self._batches()
        while True:
            with span("loader.batch") as s:
                batch = next(batches, None)
            self.stats.read_seconds += s.ns * 1e-9
            if batch is None:
                return
            yield batch

    def _batches(self) -> Iterator[ChainBatch]:
        cfg = self.config
        for ex in self._shuffled():
            key = bucket_key(ex)
            bucket = self._pending.setdefault(key, [])
            bucket.append(ex)
            if len(bucket) >= cfg.batch_size:
                yield self._emit(key)
        if not cfg.drop_remainder:
            for key in list(self._pending):
                if self._pending[key]:
                    yield self._emit(key)
        self.stats.files_done = self.iterator.files_done

    @property
    def readers(self) -> str:
        """The parsers that ran so far: "native", "python" or
        "native+python" (io/native.py best_reader)."""
        return "+".join(sorted(self.iterator.readers_used))

    def _emit(self, key) -> ChainBatch:
        examples = self._pending.pop(key)
        batch = make_batch(examples,
                           max_fst_states=self.config.max_fst_states,
                           max_fst_arcs=self.config.max_fst_arcs)
        self.stats.batches += 1
        return batch

    def summary(self) -> str:
        s = self.stats
        return (f"examples={s.examples_read} skipped={s.examples_skipped} "
                f"batches={s.batches} files={s.files_done} "
                f"reader={self.readers} "
                f"read_s={s.read_seconds:.2f} skip_reasons={s.skip_reasons}")


class PrefetchLoader:
    """Background-thread prefetch around a DataLoader (or any batch
    iterable): host-side parse/assembly overlaps device compute, the
    realization of the reference's planned goroutine pipeline +
    pinned-buffer ring (ref: docs/kaldi_fp16_complete_report.md §3.5-3.6;
    only the pinned-buffer half landed there, bridge.go:229-366).

    The native cegs parser (io/native.py) releases the GIL inside its C
    calls, so a single producer thread achieves true parse/step overlap.
    `depth` bounds the queue (a ring of ready batches).  Exceptions in the
    producer are re-raised at the consumer.
    """

    _DONE = object()

    def __init__(self, loader, depth: int = 2):
        import queue as _queue
        import threading
        self.loader = loader
        self._queue = _queue.Queue(maxsize=max(1, depth))
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._error = None
        self._thread.start()

    def _produce(self):
        try:
            for batch in self.loader:
                while True:
                    if getattr(self, "_stop", False):
                        return
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except Exception:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._error = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer (it may be blocked on a full queue after an
        early consumer break) and join it — otherwise each abandoned epoch
        leaks a thread pinning open readers and buffered batches."""
        self._stop = True
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except Exception:
                pass
            self._thread.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                break

    def summary(self) -> str:
        return getattr(self.loader, "summary", lambda: "")()


class MultiPrefetchLoader:
    """Multi-worker host ingestion: W PrefetchLoaders over round-robin
    file shards (`shard_files`), merged round-robin (deterministic for a
    fixed file list) or, with deterministic=False, first-ready: each
    worker's batches in its own order, the workers' interleaved as they
    come.  use_native: the workers' parser (DataLoader's).  For parse/step
    overlap and worker-style file sharding; the JAX package's own
    measurement (its dataloader.py:283-293) found extra threads add no
    parse rate, because batch assembly holds the GIL: ProcessLoader scales
    that."""

    def __init__(self, pattern_or_files, config: DataLoaderConfig,
                 workers: int = 4, depth: int = 2,
                 deterministic: bool = True, use_native: bool = True):
        if isinstance(pattern_or_files, str):
            files = sorted(globlib.glob(pattern_or_files))
        else:
            files = list(pattern_or_files)
        if not files:
            raise FileNotFoundError(f"no ark files match {pattern_or_files!r}")
        self.workers = max(1, min(workers, len(files)))
        self.deterministic = deterministic
        self.loaders = [DataLoader(shard_files(files, w, self.workers), config,
                                   use_native=use_native)
                        for w in range(self.workers)]
        self._prefetchers = [PrefetchLoader(ld, depth=depth)
                             for ld in self.loaders]

    def __iter__(self):
        iters = [iter(p) for p in self._prefetchers]
        if not self.deterministic:
            yield from self._first_ready(iters)
            return
        live = list(range(self.workers))
        w = 0
        while live:
            i = live[w % len(live)]
            try:
                yield next(iters[i])
                w += 1
            except StopIteration:
                live.remove(i)

    def _first_ready(self, iters):
        """The workers' batches in the order they arrive: a pump thread per
        worker feeds one bounded queue, and each pump's end is a None
        (dataloader.py:331-358 there).  A worker's error ends its pump; the
        PrefetchLoader raises it from that worker's next()."""
        shared: queue.Queue = queue.Queue(maxsize=max(1, 2 * self.workers))
        errors: list = []

        def pump(it):
            try:
                for b in it:
                    shared.put(b)
            except BaseException as e:   # noqa: BLE001 - re-raised below
                errors.append(e)
            finally:
                shared.put(None)

        for it in iters:
            threading.Thread(target=pump, args=(it,), daemon=True).start()
        finished = 0
        while finished < self.workers:
            item = shared.get()
            if item is None:
                finished += 1
                if errors:
                    raise errors[0]
                continue
            yield item

    def close(self, timeout: float = 5.0) -> None:
        for p in self._prefetchers:
            p.close(timeout=max(0.05, timeout / max(1, self.workers)))

    def summary(self) -> str:
        return " | ".join(ld.summary() for ld in self.loaders)


def _process_worker_main(files, config, use_native, q):
    """Module-level worker body (spawn-picklable): parse + assemble a
    file shard entirely in this process, ship finished ChainBatches."""
    try:
        dl = DataLoader(files, config, use_native=use_native)
        for b in dl:
            q.put(("batch", b))
        q.put(("done", dl.summary()))
    except Exception as e:  # noqa: BLE001 — propagated to the parent
        import traceback
        q.put(("error", f"{type(e).__name__}: {e}\n"
                        f"{traceback.format_exc()}"))


class ProcessLoader:
    """Multi-PROCESS host ingestion: W OS-process workers, each a full
    DataLoader (parse + validate + bucket + FST->padded batch) over a
    round-robin file shard, shipping ready ChainBatches through a
    bounded queue.

    Thread workers stop scaling because batch ASSEMBLY holds the GIL; a
    process owns its whole pipeline, so W workers parse AND assemble
    concurrently (pickle transport of ~MB numpy batches costs far less
    than assembly).  Deterministic round-robin merge given a fixed file
    list.

    Workers import nothing but numpy and this package's io modules, never
    torch, so they never touch CUDA; 'spawn' start is safe beside an
    initialised CUDA context in the parent.
    """

    def __init__(self, pattern_or_files, config: DataLoaderConfig,
                 workers: int = 4, depth: int = 4,
                 use_native: bool = True):
        import multiprocessing as mp
        if isinstance(pattern_or_files, str):
            files = sorted(globlib.glob(pattern_or_files))
        else:
            files = list(pattern_or_files)
        if not files:
            raise FileNotFoundError(f"no ark files match {pattern_or_files!r}")
        workers = max(1, min(workers, len(files)))
        self.workers = workers
        ctx = mp.get_context("spawn")
        self._queues = [ctx.Queue(maxsize=max(1, depth))
                        for _ in range(workers)]
        self._procs = [
            ctx.Process(
                target=_process_worker_main,
                args=(shard_files(files, w, workers), config, use_native,
                      self._queues[w]),
                daemon=True)
            for w in range(workers)
        ]
        for p in self._procs:
            p.start()
        self._summaries: List[str] = []

    def __iter__(self) -> Iterator[ChainBatch]:
        import queue as _queue
        live = list(range(self.workers))
        w = 0
        while live:
            i = live[w % len(live)]
            try:
                kind, payload = self._queues[i].get(timeout=10.0)
            except _queue.Empty:
                # a worker that died without a sentinel (segfault in the
                # native parser, OOM-kill) must not hang the feeder
                if i < len(self._procs) and not self._procs[i].is_alive():
                    code = self._procs[i].exitcode
                    self.close()
                    raise RuntimeError(
                        f"loader worker {i} died without a message "
                        f"(exit code {code}) — native-parser crash or "
                        f"OOM kill") from None
                continue
            if kind == "batch":
                w += 1
                yield payload
            elif kind == "done":
                self._summaries.append(payload)
                live.remove(i)
            else:
                self.close()
                raise RuntimeError(f"loader worker {i} failed: {payload}")

    def close(self, timeout: float = 5.0) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=timeout / max(1, self.workers))
        for q in self._queues:
            q.close()

    def summary(self) -> str:
        return " | ".join(self._summaries) if self._summaries else \
            f"ProcessLoader({self.workers} workers running)"
