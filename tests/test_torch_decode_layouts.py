"""The port's ELL and tree-ELL decode layouts against the JAX package's.

kaldi_fp16_tpu_torch/decode/device_viterbi.py's `EllGraph` /
`TreeEllGraph` (numpy copies) and its `_Ell` / `_Tree` frame steps run on
the CPU here, the JAX ones (decode/tpu_viterbi.py) on JAX's CPU backend,
on the graphs of tests/test_tpu_viterbi.py and seeded numpy loglikes:

* the tables equal JAX's array for array, both directions, widths 2, 4
  and 128 (the hub graph's several levels, `row_state`, `slot_arc`);
* each layout's Viterbi (best, last, arcs_taken), plain and checkpointed,
  equals the same JAX layout's bit for bit at acoustic scale 1.0 (where
  scale * ll is exact), and its decoded words, alignments and
  final_reached equal the segment layout's, costs within rtol 1e-5;
* each layout's packed keep-masks and best equal the same JAX layout's
  bit for bit, and its lattices' arc sets (tests/test_tpu_viterbi.py's
  `_arc_set`, costs to 1e-4) equal the segment layout's.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.decode import tpu_viterbi as jv
from kaldi_fp16_tpu.io.fst import Fst as JFst, FstArc as JArc, FstState as JState
from kaldi_fp16_tpu_torch.decode import device_viterbi as pv
from tests import test_tpu_viterbi
from tests.test_torch_decode_host import both_graphs
from tests.test_torch_decode_lattice import assert_lattices_match
from tests.test_torch_decode_viterbi import (
    COST_RTOL, _cross_tie_graph, _tie_graph, assert_results_equal,
)
from tests.test_tpu_viterbi import random_eps_free_graph

arc_set = test_tpu_viterbi.TestDeviceLattice._arc_set


def hub_fst(fanin=53, seed=0):
    """tests/test_tpu_viterbi.py:632: start -> {mid_i} -> sink, a fan-in
    of 53 at the sink (14 level-1 rows at width 4, then 4, then 1)."""
    rng = np.random.default_rng(seed)
    s = [JState() for _ in range(fanin + 2)]
    sink = fanin + 1
    for i in range(1, fanin + 1):
        s[0].arcs.append(JArc(int(rng.integers(1, 6)),
                              float(rng.uniform(0, 2)), i, olabel=i))
        s[i].arcs.append(JArc(int(rng.integers(1, 6)),
                              float(rng.uniform(0, 2)), sink, olabel=0))
    s[sink].final = 0.0
    return JFst(start=0, states=s)


def no_arc_fst():
    s = [JState() for _ in range(2)]
    s[1].final = 0.0
    return JFst(start=0, states=s)


GRAPHS = {"random0": lambda: random_eps_free_graph(seed=0),
          "random3": lambda: random_eps_free_graph(seed=3),
          "hub": hub_fst, "tie": _tie_graph, "cross_tie": _cross_tie_graph,
          "no_arcs": no_arc_fst}


def both_arcs(fst):
    jg, pg = both_graphs(fst)
    return jv.ArcGraph.from_graph(jg), pv.ArcGraph.from_graph(pg)


def assert_tables_equal(p, j, names):
    for name in names:
        pv_, jv_ = getattr(p, name), getattr(j, name)
        if isinstance(jv_, tuple):
            assert len(pv_) == len(jv_), name
            for k, (x, y) in enumerate(zip(pv_, jv_)):
                if isinstance(y, tuple):
                    assert len(x) == len(y), (name, k)
                    for xx, yy in zip(x, y):
                        np.testing.assert_array_equal(xx, yy, err_msg=name)
                        assert xx.dtype == yy.dtype, name
                else:
                    np.testing.assert_array_equal(x, y, err_msg=name)
                    assert x.dtype == y.dtype, name
        else:
            np.testing.assert_array_equal(pv_, jv_, err_msg=name)


@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_tables_equal_jax(name, direction):
    ja, pa = both_arcs(GRAPHS[name]())
    assert_tables_equal(pv.EllGraph.from_arcs(pa, direction),
                        jv.EllGraph.from_arcs(ja, direction),
                        ("src", "pdf", "weight", "arc", "new_of_old",
                         "num_states", "num_arcs"))


@pytest.mark.parametrize("width", [2, 4, 128])
@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tree_tables_equal_jax(name, direction, width):
    ja, pa = both_arcs(GRAPHS[name]())
    p = pv.TreeEllGraph.from_arcs(pa, direction, max_width=width)
    j = jv.TreeEllGraph.from_arcs(ja, direction, max_width=width)
    assert_tables_equal(p, j, ("src", "pdf", "weight", "arc", "levels",
                               "row_state", "num_states", "num_arcs",
                               "max_width"))
    if name == "hub" and width == 4:
        assert len(p.levels) >= 2          # several reduce levels
    # the lattice's slot -> arc map: every arc in exactly one slot
    slot_arc = np.concatenate([x.reshape(-1) for x in p.arc])
    live = slot_arc[slot_arc < p.num_arcs]
    assert sorted(live.tolist()) == list(range(p.num_arcs))


def test_tables_to_device_are_int64_indices():
    _, pa = both_arcs(hub_fst())
    t = pv.TreeEllGraph.from_arcs(pa, "out", max_width=4).to("cpu")
    for x in t.src + t.pdf + t.arc + t.row_state + sum(t.levels, ()):
        assert x.dtype == torch.int64
    assert all(x.dtype == torch.float32 for x in t.weight)
    e = pv.EllGraph.from_arcs(pa, "in").to("cpu")
    assert e.new_of_old.dtype == torch.int64
    np.testing.assert_array_equal(
        e.new_of_old.numpy(), pv.EllGraph.from_arcs(pa, "in").new_of_old)


# --- Viterbi ---------------------------------------------------------------

def jax_layout_path(dec, ll):
    """JAX's (best, last, arcs_taken) of the decoder's layout, as its
    decode_batch picks the kernel."""
    src, dst, pdf, weight, final = dec._dev
    S = dec.arcs.num_states
    B, T, _ = ll.shape
    if dec.layout == "ell":
        bsrc, bpdf, bw, barc, new_of_old = dec._ell_dev
        out = jv._ell_viterbi(bsrc, bpdf, bw, barc, new_of_old, src, final,
                              dec._start_j, ll, dec._scale_j, num_states=S)
    else:
        bsrc, bpdf, bw, barc, levels = dec._tree_dev
        if T * S * B * 4 > dec.bp_hist_limit:
            chunk = jv._pick_chunk(T, S, B, dec.bp_hist_limit)
            out = jv._tree_viterbi_ckpt(bsrc, bpdf, bw, barc, levels, src,
                                        final, dec._start_j, ll,
                                        dec._scale_j, num_states=S,
                                        chunk=chunk)
        else:
            out = jv._tree_viterbi(bsrc, bpdf, bw, barc, levels, src, final,
                                   dec._start_j, ll, dec._scale_j,
                                   num_states=S)
    return [np.asarray(x) for x in out]


def both_layout(fst, layout, width=128, scale=1.0, hist_limit=None):
    jg, pg = both_graphs(fst)
    kw = dict(tree_max_width=width) if layout == "tree" else {}
    j = jv.SparseViterbiDecoder(jg, acoustic_scale=scale, layout=layout,
                                **kw)
    p = pv.SparseViterbiDecoder(pg, acoustic_scale=scale, layout=layout,
                                device="cpu", **kw)
    seg = pv.SparseViterbiDecoder(pg, acoustic_scale=scale, device="cpu")
    if hist_limit is not None:
        j.bp_hist_limit = p.bp_hist_limit = hist_limit
    return j, p, seg


def check_viterbi(fst, ll, layout, width=128, scale=1.0, hist_limit=None):
    j, p, seg = both_layout(fst, layout, width, scale, hist_limit)
    assert p.layout == layout
    pres = p.decode_batch(ll)
    assert_results_equal(seg.decode_batch(ll), pres)
    assert_results_equal(j.decode_batch(ll), pres)
    if scale == 1.0:
        pbest, plast, parcs = (x.numpy() for x in p.arc_path(ll))
        jbest, jlast, jarcs = jax_layout_path(j, ll)
        np.testing.assert_array_equal(parcs, jarcs)
        np.testing.assert_array_equal(plast, jlast)
        np.testing.assert_array_equal(pbest, jbest)
    return pres


@pytest.mark.parametrize("scale", [1.0, 0.1])
@pytest.mark.parametrize("layout,width", [("ell", 128), ("tree", 4),
                                          ("tree", 2), ("tree", 128)])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_viterbi_matches_segment_and_jax(seed, layout, width, scale):
    """tests/test_tpu_viterbi.py:344 and :646."""
    ll = np.random.default_rng(seed + 100).normal(size=(3, 9, 12)).astype(
        np.float32)
    check_viterbi(random_eps_free_graph(seed=seed), ll, layout, width, scale)


@pytest.mark.parametrize("layout,width", [("ell", 128), ("tree", 4),
                                          ("tree", 2)])
def test_hub_graph(layout, width):
    """:377 and :663: a fan-in of 53 (ELL's padded 64-wide bucket; three
    tree levels at width 4)."""
    ll = np.random.default_rng(9).normal(size=(2, 2, 5)).astype(np.float32)
    pres = check_viterbi(hub_fst(), ll, layout, width)
    _, pg = both_graphs(hub_fst())
    dense = pv.DenseViterbiDecoder(pg, device="cpu").decode_batch(ll)
    for r, d in zip(pres, dense):
        assert r["words"] == d["words"]
        np.testing.assert_allclose(r["total_cost"], d["total_cost"],
                                   rtol=COST_RTOL)


@pytest.mark.parametrize("layout,width", [("ell", 128), ("tree", 2)])
@pytest.mark.parametrize("make", [_tie_graph, _cross_tie_graph])
def test_ties_go_to_the_smallest_arc_id(make, layout, width):
    """:361, :687 and :701 (the cross-row tie: equal scores in different
    level-1 rows at width 2)."""
    ll = np.zeros((1, 2, 3), np.float32)
    pres = check_viterbi(make(), ll, layout, width)
    if make is _tie_graph:
        assert pres[0]["words"] == [7]


@pytest.mark.parametrize("seed,T,width", [(6, 11, 4), (2, 12, 2),
                                          (4, 13, 128)])
def test_tree_checkpointed_path(seed, T, width):
    """:721 (bp_hist_limit 64: chunks of one frame) and ragged chunks: the
    checkpointed tree decode equals the plain one, JAX's and the
    segment's."""
    fst = random_eps_free_graph(seed=seed)
    S, B = fst.num_states, 2
    limit = 64 if seed == 6 else T * S * B * 4 // 3
    ll = np.random.default_rng(11).normal(size=(B, T, 12)).astype(
        np.float32)
    pres = check_viterbi(fst, ll, "tree", width, hist_limit=limit)
    _, plain, _ = both_layout(fst, "tree", width)
    assert pres == plain.decode_batch(ll)
    np.testing.assert_array_equal(
        both_layout(fst, "tree", width, hist_limit=limit)[1]
        .arc_path(ll)[2].numpy(), plain.arc_path(ll)[2].numpy())


def test_ell_viterbi_has_no_checkpointed_path():
    """JAX's ELL kernel keeps the whole history at any size; so does the
    port's (bp_hist_limit does not route it)."""
    fst = random_eps_free_graph(seed=2)
    ll = np.random.default_rng(2).normal(size=(3, 12, 12)).astype(np.float32)
    check_viterbi(fst, ll, "ell", hist_limit=1)


@pytest.mark.parametrize("layout", ["ell", "tree"])
def test_unreachable_final_and_no_arcs(layout):
    s = [JState() for _ in range(4)]
    s[0].arcs.append(JArc(1, 0.0, 1))
    s[1].arcs.append(JArc(2, 0.0, 2))
    s[2].arcs.append(JArc(3, 0.0, 3))
    s[3].final = 0.0
    pres = check_viterbi(JFst(start=0, states=s),
                         np.zeros((2, 2, 4), np.float32), layout, 2)
    assert not any(r["final_reached"] for r in pres)
    jg, pg = both_graphs(no_arc_fst())
    ll = np.zeros((2, 3, 4), np.float32)
    assert pv.SparseViterbiDecoder(pg, layout=layout, device="cpu") \
        .decode_batch(ll) == jv.SparseViterbiDecoder(
            jg, layout=layout).decode_batch(ll)


# --- lattices --------------------------------------------------------------

def jax_layout_masks(dec, ll):
    """JAX's (packed, best) of the lattice decoder's layout."""
    B, T, _ = ll.shape
    S = dec.arcs.num_states
    if dec.layout == "ell":
        out = jv._lattice_masks_ell(
            *dec._ell_in, *dec._ell_out, dec._src, dec._dst, dec._pdf,
            dec._gcost, dec._fcost, dec._start, ll, dec._scale_j,
            dec._beam_j, num_states=S)
    elif T * S * B * 4 > dec.alpha_hist_limit:
        chunk = jv._pick_chunk(T, S, B, dec.alpha_hist_limit)
        out = jv._lattice_masks_tree_ckpt(
            dec._tree_in, dec._tree_out, dec._tree_rstate, dec._fcost,
            dec._start, ll, dec._scale_j, dec._beam_j, num_states=S,
            chunk=chunk)
    else:
        out = jv._lattice_masks_tree(
            dec._tree_in, dec._tree_out, dec._tree_rstate, dec._fcost,
            dec._start, ll, dec._scale_j, dec._beam_j, num_states=S)
    return [np.asarray(x) for x in out]


def both_lattice_layout(fst, layout, width=128, hist_limit=None, **kw):
    jg, pg = both_graphs(fst)
    tw = dict(tree_max_width=width) if layout == "tree" else {}
    j = jv.DeviceLatticeDecoder(jg, layout=layout, **tw, **kw)
    p = pv.DeviceLatticeDecoder(pg, layout=layout, device="cpu", **tw, **kw)
    seg = pv.DeviceLatticeDecoder(pg, device="cpu", **kw)
    if hist_limit is not None:
        j.alpha_hist_limit = p.alpha_hist_limit = hist_limit
    return j, p, seg


def check_lattices(fst, ll, layout, width=128, hist_limit=None, **kw):
    j, p, seg = both_lattice_layout(fst, layout, width, hist_limit, **kw)
    plats = p.decode_batch(ll)
    slats = seg.decode_batch(ll)
    for b, (x, y) in enumerate(zip(plats, slats)):
        assert arc_set(x) == arc_set(y), b
    assert_lattices_match(j.decode_batch(ll), plats)
    ppacked, pbest = (x.numpy() for x in p.masks(ll))
    jpacked, jbest = jax_layout_masks(j, ll)
    np.testing.assert_array_equal(ppacked, jpacked)
    np.testing.assert_array_equal(pbest, jbest)
    return p, plats


@pytest.mark.parametrize("beam", [2.0, 6.0])
@pytest.mark.parametrize("layout,width", [("ell", 128), ("tree", 4),
                                          ("tree", 128)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lattices_match_segment_and_jax(seed, layout, width, beam):
    """tests/test_tpu_viterbi.py:407 and :769."""
    ll = np.random.default_rng(seed + 10).normal(size=(2, 7, 12)).astype(
        np.float32)
    check_lattices(random_eps_free_graph(seed=seed), ll, layout, width,
                   lattice_beam=beam)


@pytest.mark.parametrize("seed,T,limit", [(1, 9, 64), (8, 11, None),
                                          (9, 12, 1)])
def test_tree_checkpointed_lattice(seed, T, limit):
    """:786 (alpha_hist_limit 64), a ragged chunk (T = 11) and chunks of
    one frame: the masks equal the plain ones and JAX's."""
    fst = random_eps_free_graph(seed=seed)
    B = 2
    limit = limit or T * fst.num_states * B * 4 * 2 // 3
    ll = np.random.default_rng(30).normal(size=(B, T, 12)).astype(
        np.float32)
    p, plats = check_lattices(fst, ll, "tree", 4, hist_limit=limit,
                              lattice_beam=5.0)
    _, plain, _ = both_lattice_layout(fst, "tree", 4, lattice_beam=5.0)
    np.testing.assert_array_equal(p.masks(ll)[0].numpy(),
                                  plain.masks(ll)[0].numpy())
    assert_lattices_match(plain.decode_batch(ll), plats)


def test_ell_lattice_refuses_an_oversized_history():
    """:604: above alpha_hist_limit the ELL lattice raises; under it the
    arc sets are the segment layout's."""
    fst = random_eps_free_graph(seed=3)
    ll = np.random.default_rng(7).normal(size=(2, 8, 12)).astype(np.float32)
    _, pg = both_graphs(fst)
    dec = pv.DeviceLatticeDecoder(pg, lattice_beam=4.0, layout="ell",
                                  device="cpu")
    dec.alpha_hist_limit = 1024
    with pytest.raises(ValueError, match="alpha_hist_limit"):
        dec.decode_batch(ll)
    dec.alpha_hist_limit = 1 << 30
    ref = pv.DeviceLatticeDecoder(pg, lattice_beam=4.0, device="cpu")
    for a, b in zip(dec.decode_batch(ll), ref.decode_batch(ll)):
        assert arc_set(a) == arc_set(b)


@pytest.mark.parametrize("layout", ["ell", "tree"])
def test_lattice_transfers_agree(layout):
    """The dense, compact and compact-overflow transfers give the same
    lattices in every layout (the tree's slot bits mapped to arcs)."""
    fst = random_eps_free_graph(seed=0)
    ll = np.random.default_rng(20).normal(size=(3, 9, 12)).astype(
        np.float32)
    lats = {}
    for transfer, cap in (("dense", 1 << 22), ("compact", 1 << 22),
                          ("compact", 2)):
        _, p, _ = both_lattice_layout(fst, layout, 4, lattice_beam=5.0,
                                      transfer=transfer, compact_cap=cap)
        lats[(transfer, cap)] = p.decode_batch(ll)
        assert p.last_transfer == (transfer if cap > 2
                                   else "compact-overflow")
    ref = lats[("dense", 1 << 22)]
    for key, got in lats.items():
        for x, y in zip(got, ref):
            assert arc_set(x) == arc_set(y), key
            for f in ("src", "dst", "ilabel", "graph_cost", "acoustic_cost"):
                np.testing.assert_array_equal(getattr(x.arcs, f),
                                              getattr(y.arcs, f))


@pytest.mark.parametrize("layout", ["ell", "tree"])
def test_lattice_unreachable_final_keeps_nothing(layout):
    s = [JState() for _ in range(4)]
    s[0].arcs.append(JArc(1, 0.0, 1))
    s[1].arcs.append(JArc(2, 0.0, 2))
    s[2].arcs.append(JArc(3, 0.0, 3))
    s[3].final = 0.0
    p, plats = check_lattices(JFst(start=0, states=s),
                              np.zeros((1, 2, 12), np.float32), layout, 2,
                              lattice_beam=8.0)
    assert len(plats[0].arcs) == 0
