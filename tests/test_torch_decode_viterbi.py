"""The port's device Viterbi decoders against the JAX package's.

`DenseViterbiDecoder` and `SparseViterbiDecoder` of
kaldi_fp16_tpu_torch/decode/device_viterbi.py run on the CPU here, the
JAX ones (decode/tpu_viterbi.py, segment layout) on JAX's CPU backend, on
the same graphs and seeded numpy loglikes.  Words, alignments and
`final_reached` must be equal and `total_cost` within rtol 1e-5.  At
acoustic scale 1.0 the product scale*ll is exact, so the arcs taken must
be bit-equal to JAX's; at 0.1 XLA may fuse the scaled add into one
rounding, and the costs may differ in the last bit.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.decode import tpu_viterbi as jv
from kaldi_fp16_tpu.io.fst import Fst as JFst, FstArc as JArc, FstState as JState
from kaldi_fp16_tpu_torch.decode import device_viterbi as pv
from tests.test_decoder import loglikes_for, two_word_graph
from tests.test_torch_decode_host import both_graphs, random_eps_graph
from tests.test_tpu_viterbi import eps_free_graph, random_eps_free_graph

COST_RTOL = 1e-5


def assert_results_equal(jres, pres):
    assert len(pres) == len(jres)
    for b, (j, p) in enumerate(zip(jres, pres)):
        assert (p["words"], p["alignment"], p["final_reached"]) == (
            j["words"], j["alignment"], j["final_reached"]), b
        np.testing.assert_allclose(p["total_cost"], j["total_cost"],
                                   rtol=COST_RTOL, err_msg=str(b))


def jax_arcs_taken(dec, ll):
    """JAX's plain or checkpointed arc kernel, as its decode_batch picks."""
    src, dst, pdf, weight, final = dec._dev
    S = dec.arcs.num_states
    B, T, _ = ll.shape
    if T * S * B * 4 > dec.bp_hist_limit:
        chunk = jv._pick_chunk(T, S, B, dec.bp_hist_limit)
        out = jv._arc_viterbi_ckpt(src, dst, pdf, weight, final,
                                   dec._start_j, ll, dec._scale_j,
                                   num_states=S, chunk=chunk)
    else:
        out = jv._arc_viterbi(src, dst, pdf, weight, final, dec._start_j,
                              ll, dec._scale_j, num_states=S)
    return [np.asarray(x) for x in out]


def both_sparse(fst, scale=1.0, hist_limit=None):
    jg, pg = both_graphs(fst)
    j = jv.SparseViterbiDecoder(jg, acoustic_scale=scale, layout="segment")
    p = pv.SparseViterbiDecoder(pg, acoustic_scale=scale, device="cpu")
    if hist_limit is not None:
        j.bp_hist_limit = p.bp_hist_limit = hist_limit
    return j, p


def test_graph_forms_equal():
    for seed in (0, 3):
        jg, pg = both_graphs(random_eps_free_graph(seed=seed))
        ja, pa = jv.ArcGraph.from_graph(jg), pv.ArcGraph.from_graph(pg)
        for name in ("src", "dst", "pdf", "ilabel", "olabel", "weight",
                     "final"):
            np.testing.assert_array_equal(getattr(pa, name),
                                          getattr(ja, name), err_msg=name)
        assert (pa.start, pa.num_states) == (ja.start, ja.num_states)
        jd, pd = jv.DenseGraph.from_graph(jg), pv.DenseGraph.from_graph(pg)
        for name in ("trans", "pdf", "ilabel", "olabel", "final"):
            np.testing.assert_array_equal(getattr(pd, name),
                                          getattr(jd, name), err_msg=name)
    assert pv.NEG_INF == jv.NEG_INF


@pytest.mark.parametrize("scale", [1.0, 0.1])
@pytest.mark.parametrize("seed", range(5))
def test_random_graphs_match_jax(seed, scale):
    fst = random_eps_free_graph(seed=seed)
    jg, pg = both_graphs(fst)
    ll = np.random.default_rng(seed).normal(size=(3, 9, 12)).astype(
        np.float32)
    assert_results_equal(
        jv.DenseViterbiDecoder(jg, acoustic_scale=scale).decode_batch(ll),
        pv.DenseViterbiDecoder(pg, acoustic_scale=scale,
                               device="cpu").decode_batch(ll))
    j, p = both_sparse(fst, scale)
    jres, pres = j.decode_batch(ll), p.decode_batch(ll)
    assert_results_equal(jres, pres)
    # the arc decoder reproduces the dense one
    assert_results_equal(pres, pv.DenseViterbiDecoder(
        pg, acoustic_scale=scale, device="cpu").decode_batch(ll))
    if scale == 1.0:
        jbest, jlast, jarcs = jax_arcs_taken(j, ll)
        pbest, plast, parcs = (x.numpy() for x in p.arc_path(ll))
        np.testing.assert_array_equal(parcs, jarcs)
        np.testing.assert_array_equal(plast, jlast)
        np.testing.assert_array_equal(pbest, jbest)


@pytest.mark.parametrize("pdfs,scale", [([1, 2], 1.0), ([3, 4], 1.0),
                                        ([1, 2, 1, 2], 1.0),
                                        ([1, 2, 3, 4], 0.1)])
def test_eps_free_graph_matches_jax(pdfs, scale):
    jg, pg = both_graphs(eps_free_graph())
    ll = loglikes_for(pdfs)[None]
    for jd, pd in (
            (jv.DenseViterbiDecoder(jg, acoustic_scale=scale),
             pv.DenseViterbiDecoder(pg, acoustic_scale=scale, device="cpu")),
            (jv.SparseViterbiDecoder(jg, acoustic_scale=scale),
             pv.SparseViterbiDecoder(pg, acoustic_scale=scale,
                                     device="cpu"))):
        jres, pres = jd.decode_batch(ll), pd.decode_batch(ll)
        assert_results_equal(jres, pres)
    assert pres[0]["words"] == {(1, 2): [1], (3, 4): [2],
                                (1, 2, 1, 2): [1, 1],
                                (1, 2, 3, 4): [1, 2]}[tuple(pdfs)]


def test_acoustic_scale_flips_the_words_as_in_jax():
    """tests/test_tpu_viterbi.py:70: a graph penalty on word 1 wins at
    acoustic scale 0.1 and loses at 1.0."""
    jg, pg = both_graphs(eps_free_graph())
    for g in (jg, pg):
        g.em_weight[g.em_ilabel == 1] = 3.0
    ll = loglikes_for([1, 2], good=10.0)[None]
    for scale, words in ((1.0, [1]), (0.1, [2])):
        for jd, pd in ((jv.DenseViterbiDecoder, pv.DenseViterbiDecoder),
                       (jv.SparseViterbiDecoder, pv.SparseViterbiDecoder)):
            jres = jd(jg, acoustic_scale=scale).decode_batch(ll)
            pres = pd(pg, acoustic_scale=scale, device="cpu").decode_batch(ll)
            assert_results_equal(jres, pres)
            assert pres[0]["words"] == words


@pytest.mark.parametrize("seed,T", [(2, 12), (5, 12), (4, 13)])
def test_checkpointed_path_matches_plain_and_jax(seed, T):
    """bp_hist_limit forces the checkpointed path, as
    tests/test_tpu_viterbi.py:546-585 do (T = 13: a ragged last chunk)."""
    fst = random_eps_free_graph(seed=seed)
    S = fst.num_states
    B = 3 if T == 12 else 2
    limit = T * S * B * 4 // (4 if T == 12 else 3)
    chunk = pv._pick_chunk(T, S, B, limit)
    assert chunk == jv._pick_chunk(T, S, B, limit)
    if T == 13:
        assert 1 < chunk < T and T % chunk != 0
    ll = np.random.default_rng(seed if T == 12 else 1).normal(
        size=(B, T, 12)).astype(np.float32)
    j, p = both_sparse(fst, hist_limit=limit)
    _, plain = both_sparse(fst)
    pres = p.decode_batch(ll)
    assert_results_equal(j.decode_batch(ll), pres)
    assert pres == plain.decode_batch(ll)
    np.testing.assert_array_equal(p.arc_path(ll)[2].numpy(),
                                  plain.arc_path(ll)[2].numpy())
    np.testing.assert_array_equal(p.arc_path(ll)[2].numpy(),
                                  jax_arcs_taken(j, ll)[2])


def test_chunk_of_one_frame():
    fst = random_eps_free_graph(seed=3)
    ll = np.random.default_rng(0).normal(size=(2, 6, 12)).astype(np.float32)
    j, p = both_sparse(fst, hist_limit=1)
    assert pv._pick_chunk(6, fst.num_states, 2, 1) == 1
    assert_results_equal(j.decode_batch(ll), p.decode_batch(ll))


def _tie_graph():
    """tests/test_tpu_viterbi.py:361: two arcs 0->1 with identical
    candidate scores; the smaller arc id (olabel 7) must win."""
    s = [JState() for _ in range(3)]
    s[0].arcs.append(JArc(1, 0.5, 1, olabel=7))
    s[0].arcs.append(JArc(1, 0.5, 1, olabel=8))
    s[1].arcs.append(JArc(2, 0.0, 2, olabel=0))
    s[2].final = 0.0
    return JFst(start=0, states=s)


def _cross_tie_graph(n=9):
    """Equal-score arcs from several sources into one sink
    (tests/test_tpu_viterbi.py:701)."""
    s = [JState() for _ in range(n + 2)]
    sink = n + 1
    for i in range(1, n + 1):
        s[0].arcs.append(JArc(1, 0.5, i, olabel=i))
        s[i].arcs.append(JArc(2, 0.5, sink, olabel=100 + i))
    s[sink].final = 0.0
    return JFst(start=0, states=s)


@pytest.mark.parametrize("make", [_tie_graph, _cross_tie_graph])
def test_ties_go_to_the_smallest_arc_id(make):
    jg, pg = both_graphs(make())
    ll = np.zeros((1, 2, 3), np.float32)
    jres = jv.SparseViterbiDecoder(jg).decode_batch(ll)
    pres = pv.SparseViterbiDecoder(pg, device="cpu").decode_batch(ll)
    assert_results_equal(jres, pres)
    assert_results_equal(jv.DenseViterbiDecoder(jg).decode_batch(ll),
                         pv.DenseViterbiDecoder(pg, device="cpu")
                         .decode_batch(ll))
    if make is _tie_graph:
        assert pres[0]["words"] == [7]
    j, p = both_sparse(make())
    np.testing.assert_array_equal(p.arc_path(ll)[2].numpy(),
                                  jax_arcs_taken(j, ll)[2])


def test_unreachable_final_matches_jax():
    """Only state 3 is final and T = 2 < 3: no path; no arc taken."""
    s = [JState() for _ in range(4)]
    s[0].arcs.append(JArc(1, 0.0, 1))
    s[1].arcs.append(JArc(2, 0.0, 2))
    s[2].arcs.append(JArc(3, 0.0, 3))
    s[3].final = 0.0
    jg, pg = both_graphs(JFst(start=0, states=s))
    ll = np.zeros((2, 2, 4), np.float32)
    pres = pv.SparseViterbiDecoder(pg, device="cpu").decode_batch(ll)
    assert_results_equal(jv.SparseViterbiDecoder(jg).decode_batch(ll), pres)
    assert not any(r["final_reached"] for r in pres)
    assert_results_equal(jv.DenseViterbiDecoder(jg).decode_batch(ll),
                         pv.DenseViterbiDecoder(pg, device="cpu")
                         .decode_batch(ll))


def test_no_emitting_arcs_gives_no_path():
    s = [JState() for _ in range(2)]
    s[1].final = 0.0
    jg, pg = both_graphs(JFst(start=0, states=s))
    ll = np.zeros((2, 3, 4), np.float32)
    jres = jv.SparseViterbiDecoder(jg).decode_batch(ll)
    pres = pv.SparseViterbiDecoder(pg, device="cpu").decode_batch(ll)
    assert pres == jres
    assert pres[0] == {"words": [], "alignment": [],
                       "total_cost": -pv.NEG_INF, "final_reached": False}


def test_epsilon_graphs_are_rejected():
    _, pg = both_graphs(two_word_graph())
    for cls in (pv.DenseGraph, pv.ArcGraph):
        with pytest.raises(ValueError):
            cls.from_graph(pg)
    for dec in (pv.DenseViterbiDecoder, pv.SparseViterbiDecoder,
                pv.DeviceLatticeDecoder):
        with pytest.raises(ValueError):
            dec(pg, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_epsilon_removed_graph_matches_jax(seed):
    from kaldi_fp16_tpu.decode.graph import remove_epsilons as jax_remove
    from kaldi_fp16_tpu_torch.decode.graph import remove_epsilons
    jg, pg = both_graphs(random_eps_graph(seed=seed))
    ll = np.random.default_rng(seed + 100).normal(size=(2, 7, 8)).astype(
        np.float32)
    assert_results_equal(
        jv.SparseViterbiDecoder(jax_remove(jg)).decode_batch(ll),
        pv.SparseViterbiDecoder(remove_epsilons(pg),
                                device="cpu").decode_batch(ll))


def test_layouts_and_mesh():
    """'auto' is the segment layout; 'ell' and 'tree' build theirs; mesh
    takes a DataGroup on the decoder's device (its decodes:
    tests/test_torch_decode_parallel.py); an unknown layout raises."""
    from kaldi_fp16_tpu_torch.parallel.mesh import DataGroup
    _, pg = both_graphs(random_eps_free_graph(seed=7))
    for cls in (pv.SparseViterbiDecoder, pv.DeviceLatticeDecoder):
        for layout in ("auto", "segment"):
            assert cls(pg, layout=layout, device="cpu").layout == "segment"
        for layout, steps in (("ell", pv._Ell), ("tree", pv._Tree)):
            dec = cls(pg, layout=layout, device="cpu")
            assert dec.layout == layout and type(dec._g) is steps
        group = DataGroup(0, 2, "cpu", "gloo")
        assert cls(pg, mesh=group, device="cpu")._rows.group is group
        with pytest.raises(TypeError, match="DataGroup"):
            cls(pg, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            cls(pg, mesh=DataGroup(0, 2, "cuda:0", "nccl"), device="cpu")
        with pytest.raises(ValueError):
            cls(pg, layout="blocked", device="cpu")


def test_no_device_means_the_card(monkeypatch):
    """Given no device, the decoders go to the card, and raise without one."""
    _, pg = both_graphs(random_eps_free_graph(seed=7))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (pv.DenseViterbiDecoder, pv.SparseViterbiDecoder,
                pv.DeviceLatticeDecoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(pg)


def test_loglikes_as_tensors_and_float64():
    """decode_batch takes float64 numpy, float32 numpy and tensors alike."""
    _, p = both_sparse(random_eps_free_graph(seed=1))
    ll = np.random.default_rng(3).normal(size=(2, 5, 12))
    ref = p.decode_batch(ll.astype(np.float32))
    assert p.decode_batch(ll) == ref
    assert p.decode_batch(torch.from_numpy(ll.astype(np.float32))) == ref
