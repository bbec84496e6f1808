"""The port's data loaders against the JAX package's, on the same files.

For one seed the port's DataLoader, PrefetchLoader and ProcessLoader must
yield the same batches as the JAX ones: the same keys in the same order,
equal feature / ivector / weight / deriv-weight arrays and equal padded
numerator graphs (the loaders are numpy copies, so equal means exactly
equal).  The cases follow tests/test_dataloader.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kaldi_fp16_tpu.io import dataloader as jdl
from kaldi_fp16_tpu_torch.io import dataloader as pdl
from kaldi_fp16_tpu_torch.io.batch import example_left_context, make_batch
from kaldi_fp16_tpu_torch.io.egs import write_ark
from kaldi_fp16_tpu_torch.io.native import native_available
from tests.test_torch_egs_io import make_example

GRAPH = ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask", "start",
         "final_logw")


def write_arks(tmp_path, n_files=3, per_file=6, frames=12, fps=4, start=0):
    files = []
    k = start
    for i in range(n_files):
        exs = [make_example("port", seed=k + j, key=f"utt-{k + j:04d}",
                            frames=frames, fps=fps) for j in range(per_file)]
        k += per_file
        p = str(tmp_path / f"cegs.{i + 1}.ark")
        write_ark(p, exs)
        files.append(p)
    return files


def assert_batches_equal(jb, pb):
    jb, pb = list(jb), list(pb)
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a.keys == b.keys
        assert (a.frames_per_seq, a.left_context) == \
            (b.frames_per_seq, b.left_context)
        for name in ("features", "ivectors", "weights", "deriv_weights"):
            x, y = getattr(a, name), getattr(b, name)
            if x is None:
                assert y is None, name
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)
        ga, gb = a.num_graph, b.num_graph
        assert (ga.num_states, ga.num_arcs) == (gb.num_states, gb.num_arcs)
        for name in GRAPH:
            np.testing.assert_array_equal(getattr(ga, name),
                                          getattr(gb, name), err_msg=name)


def both(files, use_native=True, **cfg):
    return (jdl.DataLoader(files, jdl.DataLoaderConfig(**cfg),
                           use_native=use_native),
            pdl.DataLoader(files, pdl.DataLoaderConfig(**cfg),
                           use_native=use_native))


@pytest.mark.parametrize("cfg", [
    dict(batch_size=4, label_dim=8),
    dict(batch_size=4, label_dim=8, shuffle_files=True, shuffle_buffer=5,
         seed=3, max_fst_states=16, max_fst_arcs=40),
    dict(batch_size=5, label_dim=8, drop_remainder=False, seed=1,
         shuffle_buffer=3),
], ids=["plain", "shuffled-padded", "remainder"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_loader_batches_equal(tmp_path, cfg, use_native):
    files = write_arks(tmp_path)
    j, p = both(str(tmp_path / "cegs.*.ark"), use_native, **cfg)
    assert_batches_equal(j, p)
    assert (p.stats.examples_read, p.stats.batches) == \
        (j.stats.examples_read, j.stats.batches)
    assert len(files) == p.stats.files_done
    assert p.readers == ("native" if use_native and native_available()
                         else "python")
    assert f"reader={p.readers}" in p.summary()


def test_bucketing_and_invalid_examples(tmp_path):
    exs = ([make_example("port", seed=i, key=f"aaa{i}", frames=12, fps=4)
            for i in range(3)]
           + [make_example("port", seed=9 + i, key=f"bbb{i}", frames=15,
                           fps=5) for i in range(3)])
    exs[1].supervision.weight = 0.0
    write_ark(str(tmp_path / "cegs.1.ark"), exs)
    j, p = both(str(tmp_path / "cegs.*.ark"), batch_size=2, label_dim=8)
    assert_batches_equal(j, p)
    assert p.stats.examples_skipped == j.stats.examples_skipped == 1
    assert p.stats.skip_reasons == j.stats.skip_reasons


def test_batch_assembly_matches(tmp_path):
    from kaldi_fp16_tpu.io import batch as jbatch
    from kaldi_fp16_tpu.io.egs import read_examples as jread
    from kaldi_fp16_tpu_torch.io.egs import read_examples as pread
    write_arks(tmp_path, n_files=1, per_file=4)
    path = str(tmp_path / "cegs.1.ark")
    jexs, pexs = jread(path), pread(path)
    assert example_left_context(pexs[0]) == \
        jbatch.example_left_context(jexs[0]) == 3
    assert_batches_equal([jbatch.make_batch(jexs, 24, 48)],
                         [make_batch(pexs, 24, 48)])
    with pytest.raises(ValueError):
        make_batch([pexs[0], make_example("port", 1, frames=15, fps=5)])


def test_egs_iterator_skips_corrupt_and_resets(tmp_path):
    files = write_arks(tmp_path, n_files=2, per_file=2)
    bad = tmp_path / "cegs.0.ark"
    bad.write_bytes(b"\x00" * 64)
    it = pdl.EgsIterator([str(bad)] + files)
    assert [e.key for e in it] == [e.key for e in
                                   jdl.EgsIterator([str(bad)] + files)]
    it.reset()
    assert len(list(it)) == 4
    shuffled = [pdl.EgsIterator(files * 3, shuffle=True, seed=s).files
                for s in (3, 4)]
    assert shuffled[0] == jdl.EgsIterator(files * 3, shuffle=True,
                                          seed=3).files
    with pytest.raises(FileNotFoundError):
        pdl.EgsIterator(str(tmp_path / "nope.*.ark"))


def test_prefetch_loader_equal_and_closes(tmp_path):
    import itertools
    import time
    files = write_arks(tmp_path, n_files=1, per_file=9)
    cfg = dict(batch_size=3, label_dim=8, shuffle_buffer=4, seed=2)
    j, p = both(files, **cfg)
    assert_batches_equal(j, pdl.PrefetchLoader(p, depth=2))
    pl = pdl.PrefetchLoader(itertools.count(), depth=1)
    assert next(iter(pl)) == 0
    pl.close()
    time.sleep(0.1)
    assert not pl._thread.is_alive()


def test_process_loader_equal(tmp_path):
    files = write_arks(tmp_path, n_files=4, per_file=6)
    cfg = dict(batch_size=3, label_dim=8, shuffle_buffer=4, seed=5)
    jpl = jdl.ProcessLoader(files, jdl.DataLoaderConfig(**cfg), workers=2)
    ppl = pdl.ProcessLoader(files, pdl.DataLoaderConfig(**cfg), workers=2)
    try:
        # the deterministic round-robin merge: the same batches in order
        assert_batches_equal(jpl, ppl)
        assert "reader=" in ppl.summary()
    finally:
        jpl.close()
        ppl.close()
    assert not any(pr.is_alive() for pr in ppl._procs)


def test_shard_files():
    files = [f"f{i}" for i in range(10)]
    for i in range(4):
        assert pdl.shard_files(files, i, 4) == jdl.shard_files(files, i, 4)


def test_loader_modules_do_not_import_torch():
    """ProcessLoader's spawned workers import only these modules: they must
    not pull in torch (and so can never touch CUDA)."""
    code = ("import sys, kaldi_fp16_tpu_torch.io.dataloader, "
            "kaldi_fp16_tpu_torch.io.native; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   cwd=str(Path(__file__).resolve().parents[1]))
