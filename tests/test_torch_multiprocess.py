"""The port's multi-process data-parallel worker
(`python -m kaldi_fp16_tpu_torch.tools.mpworker`), the twin of
tests/test_multiprocess.py.

N OS processes join one gloo process group on the CPU, each reads its
round-robin file shard as its rows of the global batch and runs
data-parallel steps, then saves a checkpoint (rank 0 writes) and
restores it.  The cases of the JAX test:

* 2 processes equal one process (the port's step without a data group)
  on the concatenated shards, loss rtol 1e-5 (tests/test_parallel.py's
  bar), and every process reports the same losses and parameters;
* 4 processes over 6 files split them 2/2/1/1, no file read twice;
* a SIGKILLed process makes the survivor fail, not hang;
* a checkpoint written by 2 processes restores under 4 with the
  parameters bit for bit (their bytes' digest), and training goes on.

Every wait on a worker is bounded (TIMEOUT).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.tools import mpworker
from tests.test_multiprocess import _sockets_available, _write_arks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_B = 4
TIMEOUT = 240

pytestmark = pytest.mark.skipif(not _sockets_available(),
                                reason="no local sockets")


def launch(tmp_path, nproc, steps=3, extra=(), per_pid_extra=None,
           timeout=TIMEOUT):
    """Start `nproc` workers; [(returncode, stdout, stderr, out path)]."""
    from kaldi_fp16_tpu_torch.parallel.mesh import free_address
    coordinator = free_address()[len("tcp://"):]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, outs = [], []
    for pid in range(nproc):
        out = str(tmp_path / f"out_{nproc}p_{pid}.json")
        outs.append(out)
        cmd = [sys.executable, "-m", "kaldi_fp16_tpu_torch.tools.mpworker",
               "--coordinator", coordinator, "--nproc", str(nproc),
               "--pid", str(pid), "--egs", str(tmp_path / "cegs.*.ark"),
               "--out", out, "--ckpt", str(tmp_path / "ckpt"),
               "--steps", str(steps), "--local-batch", str(LOCAL_B),
               "--device", "cpu"]
        cmd += list(extra) + list((per_pid_extra or {}).get(pid, []))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    results = []
    try:
        for p, out in zip(procs, outs):
            so, se = p.communicate(timeout=timeout)
            results.append((p.returncode, so.decode(), se.decode(), out))
    except subprocess.TimeoutExpired:
        pytest.fail("worker timed out (no clean error propagation)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def read(results):
    for rc, so, se, _ in results:
        assert rc == 0, f"worker failed rc={rc}\n{so}\n{se}"
    data = []
    for *_, out in results:
        with open(out) as f:
            data.append(json.load(f))
    return data


def one_process_losses(arks, nproc, steps):
    """The port's step without a data group on the shards' rows
    concatenated in rank order, from the worker's initial state."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, NumeratorGraphBatch, make_simple_den_fst,
    )
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.io.dataloader import shard_files
    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )
    parts = [mpworker.local_batch(shard_files(arks, r, nproc), LOCAL_B)
             for r in range(nproc)]
    batch = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    g0 = parts[0][1]
    graph = NumeratorGraphBatch(**{
        f.name: (np.concatenate([getattr(p[1], f.name) for p in parts])
                 if isinstance(getattr(g0, f.name), np.ndarray)
                 else getattr(g0, f.name))
        for f in dataclasses.fields(NumeratorGraphBatch)})
    model = build_model_from_string(mpworker.MP_XCONFIG)
    config = TrainConfig(**mpworker.TRAIN)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, "cpu")
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=mpworker.NUM_PDFS, num_states=5, seed=9),
        mpworker.NUM_PDFS), leaky=1e-4, device="cpu")
    step = make_train_step(model, net, den, graph, ChainTrainingOpts(),
                           config, num_frames_out=mpworker.T_OUT)
    losses = []
    for _ in range(steps):
        opt, scale, out = step(opt, scale, batch)
        losses.append(float(out.loss))
    return losses


def test_two_processes_equal_one_process(tmp_path):
    arks = _write_arks(tmp_path)
    data = read(launch(tmp_path, 2))
    for d in data:
        assert d["process_count"] == 2
        assert (d["device"], d["backend"]) == ("cpu", "gloo")
        assert d["losses"] == data[0]["losses"]
        assert d["param_digest"] == data[0]["param_digest"]
        assert d["ckpt_ok"]
    assert data[0]["local_files"] != data[1]["local_files"]
    np.testing.assert_allclose(data[0]["losses"],
                               one_process_losses(arks, 2, 3), rtol=1e-5)


def test_four_processes_uneven_file_shards(tmp_path):
    _write_arks(tmp_path, num_files=6, per_file=LOCAL_B)
    data = read(launch(tmp_path, 4, steps=2))
    assert sorted(len(d["local_files"]) for d in data) == [1, 1, 2, 2]
    for d in data:
        assert d["process_count"] == 4
        assert d["losses"] == data[0]["losses"]
        assert all(np.isfinite(x) for x in d["losses"])
        assert d["ckpt_ok"]
    seen = [f for d in data for f in d["local_files"]]
    assert len(seen) == len(set(seen))


def test_worker_death_fails_the_survivor(tmp_path):
    _write_arks(tmp_path)
    results = launch(tmp_path, 2, steps=50, extra=["--heartbeat", "20"],
                     per_pid_extra={1: ["--die-at-step", "3"]})
    (rc0, so0, se0, out0), (rc1, _, _, out1) = results
    assert rc1 == -9, f"the victim should die by SIGKILL, rc={rc1}"
    assert rc0 != 0, f"the survivor must fail, rc={rc0}\n{so0}\n{se0}"
    assert not os.path.exists(out0) and not os.path.exists(out1)


def test_elastic_resume_two_to_four(tmp_path):
    _write_arks(tmp_path, num_files=4, per_file=LOCAL_B)
    saved = read(launch(tmp_path, 2, steps=2))[0]
    assert saved["ckpt_ok"]
    for d in read(launch(tmp_path, 4, steps=1,
                         extra=["--restore-step", "2"])):
        assert d["process_count"] == 4
        assert d["restored_digest"] == saved["param_digest"]
        assert d["restored_param_sums"] == saved["param_sums"]
        assert all(np.isfinite(x) for x in d["losses"])
        assert d["ckpt_ok"]     # saved again at step 3 by 4 processes


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_worker_defaults_to_the_card(tmp_path):
    """Without --device a worker runs on the card: with none here, it
    fails before it joins a group."""
    from kaldi_fp16_tpu_torch.parallel.mesh import free_address
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpworker.main(["--coordinator", free_address()[len("tcp://"):],
                       "--nproc", "1", "--pid", "0",
                       "--egs", str(tmp_path / "cegs.*.ark"),
                       "--out", str(tmp_path / "out.json"),
                       "--ckpt", str(tmp_path / "ckpt")])
