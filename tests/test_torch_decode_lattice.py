"""The port's DeviceLatticeDecoder against the JAX package's.

Both decoders (segment layout) run on the CPU on the same graphs and
seeded numpy loglikes.  Lattices are compared under
tests/test_tpu_viterbi.py's `_arc_set` (frame, labels, costs rounded to
1e-4); best paths and n-best lists must have equal words, their costs
within 1e-4.  The packed keep-masks must be bit-equal to JAX's: the beta
scan's arithmetic is the same in both, and at acoustic scale 1.0 exact.
"""

import numpy as np
import pytest

from kaldi_fp16_tpu.decode import tpu_viterbi as jv
from kaldi_fp16_tpu.io.fst import Fst as JFst, FstArc as JArc, FstState as JState
from kaldi_fp16_tpu_torch.decode import device_viterbi as pv
from tests.test_decoder import loglikes_for
from tests.test_torch_decode_host import both_graphs
from tests import test_tpu_viterbi
from tests.test_tpu_viterbi import eps_free_graph, random_eps_free_graph

COST_ATOL = 1e-4
arc_set = test_tpu_viterbi.TestDeviceLattice._arc_set


def both_lattice_decoders(fst, hist_limit=None, **kw):
    jg, pg = both_graphs(fst)
    j = jv.DeviceLatticeDecoder(jg, layout="segment", **kw)
    p = pv.DeviceLatticeDecoder(pg, device="cpu", **kw)
    if hist_limit is not None:
        j.alpha_hist_limit = p.alpha_hist_limit = hist_limit
    return j, p


def assert_lattices_match(jlats, plats, nbest=3):
    assert len(plats) == len(jlats)
    for b, (j, p) in enumerate(zip(jlats, plats)):
        assert arc_set(p) == arc_set(j), b
        assert p.num_nodes == j.num_nodes, b
        (jw, jc), (pw, pc) = j.best_path(), p.best_path()
        assert pw == jw, b
        assert (not np.isfinite(jc) and not np.isfinite(pc)) \
            or abs(pc - jc) < COST_ATOL, b
        jn, pn = j.n_best(nbest), p.n_best(nbest)
        assert [w for w, _ in pn] == [w for w, _ in jn], b
        np.testing.assert_allclose([c for _, c in pn], [c for _, c in jn],
                                   atol=COST_ATOL, rtol=0)


def jax_masks(dec, ll):
    """JAX's plain or checkpointed mask kernel, as its decode_batch picks."""
    B, T, _ = ll.shape
    S = dec.arcs.num_states
    args = (dec._src, dec._dst, dec._pdf, dec._gcost, dec._fcost, dec._start,
            ll, dec._scale_j, dec._beam_j)
    if T * S * B * 4 > dec.alpha_hist_limit:
        chunk = jv._pick_chunk(T, S, B, dec.alpha_hist_limit)
        out = jv._lattice_masks_ckpt(*args, num_states=S, chunk=chunk)
    else:
        out = jv._lattice_masks(*args, num_states=S)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("beam", [2.0, 6.0])
@pytest.mark.parametrize("seed", range(3))
def test_lattices_match_jax(seed, beam):
    """tests/test_tpu_viterbi.py:159, three utterances at once."""
    j, p = both_lattice_decoders(random_eps_free_graph(seed=seed),
                                 lattice_beam=beam)
    ll = np.random.default_rng(seed + 10).normal(size=(3, 7, 12)).astype(
        np.float32)
    assert_lattices_match(j.decode_batch(ll), p.decode_batch(ll))
    jpacked, jbest = jax_masks(j, ll)
    ppacked, pbest = (x.numpy() for x in p.masks(ll))
    np.testing.assert_array_equal(ppacked, jpacked)
    np.testing.assert_array_equal(pbest, jbest)


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_acoustic_scale_matches_jax(scale):
    j, p = both_lattice_decoders(random_eps_free_graph(seed=4),
                                 lattice_beam=5.0, acoustic_scale=scale)
    ll = np.random.default_rng(40).normal(size=(2, 8, 12)).astype(np.float32)
    jlats, plats = j.decode_batch(ll), p.decode_batch(ll)
    assert_lattices_match(jlats, plats)
    for jl, pl in zip(jlats, plats):
        jw, _ = jl.best_path(acoustic_scale=scale)
        pw, _ = pl.best_path(acoustic_scale=scale)
        assert pw == jw


def test_nbest_on_the_word_graph_matches_jax():
    """tests/test_tpu_viterbi.py:175: n-best and acoustic rescaling."""
    j, p = both_lattice_decoders(eps_free_graph(), lattice_beam=20.0)
    ll = loglikes_for([1, 2, 1, 2])[None]
    jl, pl = j.decode_batch(ll)[0], p.decode_batch(ll)[0]
    assert_lattices_match([jl], [pl], nbest=3)
    assert pl.n_best(3)[0][0] == pl.best_path()[0]
    assert pl.best_path(acoustic_scale=0.01)[0] == \
        jl.best_path(acoustic_scale=0.01)[0]


@pytest.mark.parametrize("seed", [0, 3])
def test_compact_transfer_matches_dense(seed):
    """tests/test_tpu_viterbi.py:198: the compacted mask gives the same
    lattices as the dense one, in the port and in JAX."""
    fst = random_eps_free_graph(seed=seed)
    ll = np.random.default_rng(seed + 20).normal(size=(3, 9, 12)).astype(
        np.float32)
    out = {}
    for transfer in ("dense", "compact"):
        j, p = both_lattice_decoders(fst, lattice_beam=5.0,
                                     transfer=transfer)
        out[transfer] = (j.decode_batch(ll), p.decode_batch(ll))
        assert p.last_transfer == transfer
    for b in range(3):
        lats = [out[t][side][b] for t in ("dense", "compact")
                for side in (0, 1)]
        assert all(arc_set(x) == arc_set(lats[0]) for x in lats[1:]), b
        assert len({x.num_nodes for x in lats}) == 1, b
        for f in ("src", "dst", "graph_cost", "acoustic_cost"):
            np.testing.assert_array_equal(getattr(out["compact"][1][b].arcs, f),
                                          getattr(out["dense"][1][b].arcs, f))


def test_auto_transfer_compacts_large_masks():
    fst = random_eps_free_graph(seed=2)
    ll = np.random.default_rng(5).normal(size=(2, 9, 12)).astype(np.float32)
    _, p = both_lattice_decoders(fst, lattice_beam=5.0)
    p.decode_batch(ll)
    assert p.last_transfer == "dense"            # 2 x 9 x 20 mask bytes
    p.AUTO_COMPACT_BYTES = 100
    lats = p.decode_batch(ll)
    assert p.last_transfer == "compact"
    _, dense = both_lattice_decoders(fst, lattice_beam=5.0, transfer="dense")
    assert [arc_set(x) for x in lats] == \
        [arc_set(x) for x in dense.decode_batch(ll)]


def test_compact_overflow_ships_the_dense_mask():
    """tests/test_tpu_viterbi.py:219: over compact_cap the dense transfer
    runs, with the same lattices."""
    fst = random_eps_free_graph(seed=1)
    ll = np.random.default_rng(30).normal(size=(2, 8, 12)).astype(np.float32)
    jd, _ = both_lattice_decoders(fst, lattice_beam=20.0, transfer="dense")
    jt, pt = both_lattice_decoders(fst, lattice_beam=20.0, transfer="compact",
                                   compact_cap=2)
    plats = pt.decode_batch(ll)
    assert pt.last_transfer == "compact-overflow"
    assert_lattices_match(jd.decode_batch(ll), plats)
    assert_lattices_match(jt.decode_batch(ll), plats)


def test_unreachable_final_keeps_nothing():
    """tests/test_tpu_viterbi.py:234: best == INF must not saturate the
    threshold into keep-everything."""
    s = [JState() for _ in range(4)]
    s[0].arcs.append(JArc(1, 0.0, 1))
    s[1].arcs.append(JArc(2, 0.0, 2))
    s[2].arcs.append(JArc(3, 0.0, 3))
    s[3].final = 0.0
    j, p = both_lattice_decoders(JFst(start=0, states=s), lattice_beam=8.0)
    ll = np.zeros((1, 2, 12), np.float32)
    lat = p.decode_batch(ll)[0]
    assert len(lat.arcs) == 0
    words, cost = lat.best_path()
    assert words == [] and not np.isfinite(cost)
    assert_lattices_match(j.decode_batch(ll), [lat])
    assert not p.masks(ll)[0].any()


def test_no_emitting_arcs():
    s = [JState() for _ in range(2)]
    s[1].final = 0.0
    j, p = both_lattice_decoders(JFst(start=0, states=s))
    ll = np.zeros((2, 3, 4), np.float32)
    plats = p.decode_batch(ll)
    assert [x.num_nodes for x in plats] == [1, 1]
    assert_lattices_match(j.decode_batch(ll), plats)


@pytest.mark.parametrize("seed,T,B,frac", [(9, 12, 2, (2, 3)),
                                           (8, 11, 2, (2, 3)),
                                           (3, 6, 1, None)])
def test_checkpointed_alpha_matches_plain_and_jax(seed, T, B, frac):
    """tests/test_tpu_viterbi.py:428-459 and :587 (T = 11: a ragged last
    chunk; limit 1: chunks of one frame)."""
    fst = random_eps_free_graph(seed=seed)
    limit = (T * fst.num_states * B * 4 * frac[0] // frac[1]
             if frac else 1)
    ll = np.random.default_rng(seed).normal(size=(B, T, 12)).astype(
        np.float32)
    j, p = both_lattice_decoders(fst, hist_limit=limit, lattice_beam=5.0)
    _, plain = both_lattice_decoders(fst, lattice_beam=5.0)
    plats = p.decode_batch(ll)
    assert_lattices_match(j.decode_batch(ll), plats)
    assert_lattices_match(plain.decode_batch(ll), plats)
    ppacked = p.masks(ll)[0].numpy()
    np.testing.assert_array_equal(ppacked, plain.masks(ll)[0].numpy())
    np.testing.assert_array_equal(ppacked, jax_masks(j, ll)[0])

