"""Data-parallel decoding: the port's decoders with `mesh=` on two gloo
ranks spawned on the CPU, against one process and the JAX package.

The cases of tests/test_parallel.py's `TestDataParallelDecode` (:316-425),
on its graphs (30 states, 3 arcs each, 12 pdfs) and loglike seeds, in the
segment and the tree layout (width 4): `SparseViterbiDecoder`,
`DeviceLatticeDecoder` and `WindowedStreamingDecoder` (window 16, chunks
of 8, with commits).  Decoding has no reduction across rows, so every
rank must return what one process returns for all B rows bit for bit:
the arcs taken, best scores and packed masks, the results and the
commits; and the words and alignments of the JAX package's unsharded
decoder, costs within 1e-4 (test_parallel.py's bar).  Each decode call
runs one all-reduce (a feed that commits nothing, none).  A batch the
ranks do not divide raises ValueError before any collective.

Every case runs in one spawned process group (a module fixture), its
wait bounded by JOIN_SECONDS.
"""

import numpy as np
import pytest

from kaldi_fp16_tpu.decode import streaming as js
from kaldi_fp16_tpu.decode import tpu_viterbi as jv
from kaldi_fp16_tpu.io.fst import Fst as JFst, FstArc as JArc, FstState as JState
from kaldi_fp16_tpu_torch.decode import device_viterbi as pv
from kaldi_fp16_tpu_torch.decode import streaming as ps
from kaldi_fp16_tpu_torch.parallel.mesh import DataGroup, spawn_ranks
from tests import test_tpu_viterbi
from tests.test_torch_decode_host import both_graphs

WORLD = 2
JOIN_SECONDS = 240
COST_ATOL = 1e-4                 # tests/test_parallel.py:347
P = 12
arc_set = test_tpu_viterbi.TestDeviceLattice._arc_set

# (kind, layout, graph seed, loglike seed, B, T); test_parallel.py's
# seeds: Viterbi :336 / :352, windowed :370, lattice :412
CASES = (("viterbi", "segment", 5, 33, 8, 11),
         ("viterbi", "tree", 9, 45, 8, 7),
         ("lattice", "segment", 6, 44, 8, 9),
         ("lattice", "tree", 6, 44, 8, 9),
         ("windowed", "arc", 12, 50, 8, 32),
         ("windowed", "tree", 12, 50, 8, 32))
WINDOW, CHUNK = 16, 8


def dp_fst(seed):
    """tests/test_parallel.py:320's graph, as an Fst."""
    rng = np.random.default_rng(seed)
    n = 30
    states = [JState() for _ in range(n)]
    for s in range(n):
        for _ in range(3):
            states[s].arcs.append(JArc(
                int(rng.integers(1, P + 1)), float(rng.uniform(0, 2)),
                int(rng.integers(0, n)), olabel=int(rng.integers(0, 5))))
        if rng.uniform() < 0.4:
            states[s].final = float(rng.uniform(0, 1))
    states[0].final = 0.0
    return JFst(start=0, states=states)


def case_loglikes(case):
    kind, _, _, ll_seed, B, T = case
    ll = np.random.default_rng(ll_seed).normal(size=(B, T, P)).astype(
        np.float32)
    return ll * 3.0 if kind == "windowed" else ll


def run_case(case, group):
    """One case with `mesh=group` (None: one process), as numpy: the
    decode's outputs and the collectives of each call."""
    kind, layout, seed, _, B, T = case
    pg = both_graphs(dp_fst(seed))[1]
    ll = case_loglikes(case)
    kw = dict(tree_max_width=4) if layout == "tree" else {}
    calls = []

    def counted(fn, *args):
        before = group.calls if group else 0
        out = fn(*args)
        calls.append((group.calls - before) if group else 0)
        return out

    if kind == "viterbi":
        dec = pv.SparseViterbiDecoder(pg, layout=layout, mesh=group,
                                      device="cpu", **kw)
        res = counted(dec.decode_batch, ll)
        path = [x.numpy() for x in counted(dec.arc_path, ll)]
        return {"results": res, "path": path, "calls": calls}
    if kind == "lattice":
        dec = pv.DeviceLatticeDecoder(pg, lattice_beam=5.0, layout=layout,
                                      mesh=group, device="cpu", **kw)
        lats = counted(dec.decode_batch, ll)
        masks = [x.numpy() for x in counted(dec.masks, ll)]
        return {"arc_sets": [arc_set(x) for x in lats],
                "best_paths": [x.best_path() for x in lats],
                "masks": masks, "calls": calls}
    dec = ps.WindowedStreamingDecoder(pg, acoustic_scale=0.7, window=WINDOW,
                                      layout=layout, mesh=group,
                                      device="cpu", **kw)
    st = dec.init(B)
    for t0 in range(0, T, CHUNK):
        st = counted(dec.feed, st, ll[:, t0:t0 + CHUNK])
    return {"committed": [np.asarray(c) for c in st.committed],
            "window_frames": st.window_frames,
            "partial": counted(dec.partial, st),
            "results": counted(dec.finalize, st), "calls": calls}


def decode_cases(group, cases):
    """A spawned rank: every case under the data group."""
    return [run_case(case, group) for case in cases]


@pytest.fixture(scope="module")
def ranks():
    """[rank][case] results of the two-rank group."""
    return spawn_ranks(decode_cases, ["cpu"] * WORLD, args=(CASES,),
                       backend="gloo", join_seconds=JOIN_SECONDS)


@pytest.fixture(scope="module")
def single():
    return [run_case(case, None) for case in CASES]


def assert_same(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "calls":
            continue
        if isinstance(ref[k], list) and ref[k] and isinstance(
                ref[k][0], np.ndarray):
            assert len(got[k]) == len(ref[k]), k
            for x, y in zip(got[k], ref[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert got[k] == ref[k], k


def jax_decoder(case):
    kind, layout, seed, _, _, _ = case
    jg = both_graphs(dp_fst(seed))[0]
    kw = dict(tree_max_width=4) if layout == "tree" else {}
    if kind == "viterbi":
        return jv.SparseViterbiDecoder(jg, layout=layout, **kw)
    if kind == "lattice":
        return jv.DeviceLatticeDecoder(jg, lattice_beam=5.0, layout=layout,
                                       **kw)
    return js.WindowedStreamingDecoder(jg, acoustic_scale=0.7, window=WINDOW,
                                       layout=layout, **kw)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c[:2])) for c in CASES])
def test_two_ranks_equal_one_process_and_jax(ranks, single, i):
    case = CASES[i]
    for r in range(WORLD):
        assert_same(ranks[r][i], single[i])
    kind = case[0]
    got = ranks[0][i]
    # one all-reduce per decode call and per feed that commits (with
    # chunks of 8 and a window of 16, each such feed commits one chunk)
    if kind == "windowed":
        feeds = got["calls"][:-2]
        assert got["calls"][-2:] == [1, 1]
        assert set(feeds) <= {0, 1} and sum(feeds) == len(
            got["committed"]) > 0
    else:
        assert got["calls"] == [1, 1]
    ll = case_loglikes(case)
    jdec = jax_decoder(case)
    if kind == "lattice":
        jlats = jdec.decode_batch(ll)
        assert got["arc_sets"] == [arc_set(x) for x in jlats]
        return
    if kind == "windowed":
        st = jdec.init(ll.shape[0])
        for t0 in range(0, ll.shape[1], CHUNK):
            st = jdec.feed(st, ll[:, t0:t0 + CHUNK])
        np.testing.assert_array_equal(
            np.concatenate(got["committed"]),
            np.concatenate([np.asarray(c) for c in st.committed]))
        jres = jdec.finalize(st)
    else:
        jres = jdec.decode_batch(ll)
    for a, b in zip(got["results"], jres):
        assert (a["words"], a["alignment"], a["final_reached"]) == (
            b["words"], b["alignment"], b["final_reached"])
        assert abs(a["total_cost"] - b["total_cost"]) < COST_ATOL


@pytest.mark.parametrize("kind", ["viterbi", "lattice", "windowed"])
def test_ragged_batch_raises(kind):
    """B = 3 on 2 ranks: the ValueError of the JAX package's
    _DataSharding.shard_batch, before any collective."""
    pg = both_graphs(dp_fst(5))[1]
    group = DataGroup(0, WORLD, "cpu", "gloo")
    ll = np.zeros((3, 5, P), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        if kind == "viterbi":
            pv.SparseViterbiDecoder(pg, mesh=group,
                                    device="cpu").decode_batch(ll)
        elif kind == "lattice":
            pv.DeviceLatticeDecoder(pg, mesh=group,
                                    device="cpu").decode_batch(ll)
        else:
            ps.WindowedStreamingDecoder(pg, mesh=group, device="cpu").init(3)
    assert group.calls == 0
