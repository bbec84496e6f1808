"""The port's copies of the host decode modules against the JAX package's.

kaldi_fp16_tpu_torch/decode/{graph,viterbi,lattice,lm,wer}.py are numpy
copies of kaldi_fp16_tpu/decode/'s.  Both get the same graphs (the FSTs of
tests/test_decoder.py, test_lattice.py and test_tpu_viterbi.py, rebuilt
from the port's io/fst classes) and the same loglikes; words, alignments,
labels and node numbering must be equal, costs within 1e-6 (both sides
compute in float64, in the same order).
"""

import importlib

import numpy as np
import pytest

from kaldi_fp16_tpu.decode import graph as jax_graph
from kaldi_fp16_tpu.decode import lattice as jax_lattice
from kaldi_fp16_tpu.decode import lm as jax_lm
from kaldi_fp16_tpu.decode import viterbi as jax_viterbi
from kaldi_fp16_tpu_torch.decode import graph as port_graph
from kaldi_fp16_tpu_torch.decode import lattice as port_lattice
from kaldi_fp16_tpu_torch.decode import lm as port_lm
from kaldi_fp16_tpu_torch.decode import viterbi as port_viterbi
from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
from tests.test_decoder import loglikes_for, two_word_graph
from tests import test_lattice, test_tpu_viterbi
from tests.test_lattice import ambiguous_loglikes
from tests.test_tpu_viterbi import eps_free_graph, random_eps_free_graph

# both packages' decode/__init__ re-export the function `wer` over its
# module of that name
jax_wer = importlib.import_module("kaldi_fp16_tpu.decode.wer")
port_wer = importlib.import_module("kaldi_fp16_tpu_torch.decode.wer")
COST_ATOL = 1e-6
# (module attributes, so that pytest does not collect the JAX test classes
# a second time here)
random_eps_graph = test_tpu_viterbi.TestEpsilonRemoval.random_eps_graph


def port_fst(fst):
    """A JAX-package Fst rebuilt from the port's io/fst classes."""
    return Fst(start=fst.start, properties=fst.properties, states=[
        FstState(final=st.final, arcs=[
            FstArc(a.label, a.weight, a.next_state, olabel=a.olabel)
            for a in st.arcs]) for st in fst.states])


def both_graphs(fst, **kw):
    return (jax_graph.DecodingGraph.from_fst(fst, **kw),
            port_graph.DecodingGraph.from_fst(port_fst(fst), **kw))


def assert_graphs_equal(j, p):
    assert (j.num_states, j.start) == (p.num_states, p.start)
    for name in ("em_row_ptr", "em_dst", "em_ilabel", "em_olabel",
                 "eps_row_ptr", "eps_dst", "eps_olabel"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name),
                                      err_msg=name)
    for name in ("em_weight", "eps_weight", "final_cost"):
        np.testing.assert_allclose(getattr(p, name), getattr(j, name),
                                   atol=COST_ATOL, rtol=0, err_msg=name)


def acceptor_with_pushed_labels(seed):
    """TestEpsilonRemoval's random eps graph with the eps arcs' olabels
    stripped (the HCLG-pushed construction)."""
    fst = random_eps_graph(seed=seed)
    for st in fst.states:
        for a in st.arcs:
            if a.label == 0:
                a.olabel = 0
    return fst


GRAPHS = {
    "two_word": two_word_graph,
    "eps_free": eps_free_graph,
    "random3": lambda: random_eps_free_graph(seed=3),
    "random_eps0": lambda: random_eps_graph(seed=0),
    "pushed1": lambda: acceptor_with_pushed_labels(1),
}


@pytest.mark.parametrize("name", GRAPHS)
def test_decoding_graph_copies_equal(name):
    j, p = both_graphs(GRAPHS[name]())
    assert_graphs_equal(j, p)
    assert [p.pdf_of(i) for i in (1, 3)] == [j.pdf_of(i) for i in (1, 3)]
    mapped = np.array([0, 5, 6, 7, 8])
    j2, p2 = both_graphs(GRAPHS[name](), ilabel_to_pdf=mapped)
    assert p2.pdf_of(3) == j2.pdf_of(3) == 7


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("method", ["scalar", "vector"])
def test_remove_epsilons_equal(seed, method):
    j, p = both_graphs(random_eps_graph(
        S=24, NEPS=18, seed=seed))
    assert_graphs_equal(jax_graph.remove_epsilons(j, method=method),
                        port_graph.remove_epsilons(p, method=method))


def test_from_arrays_equal():
    rng = np.random.default_rng(4)
    S, E = 50, 300
    arrays = dict(num_states=S, start=0,
                  src=rng.integers(0, S, E), dst=rng.integers(0, S, E),
                  ilabel=rng.integers(0, 9, E), olabel=rng.integers(0, 4, E),
                  weight=rng.uniform(0, 2, E),
                  final_cost=rng.uniform(0, 1, S))
    assert_graphs_equal(jax_graph.DecodingGraph.from_arrays(**arrays),
                        port_graph.DecodingGraph.from_arrays(**arrays))


# (graph, loglikes, DecodeOptions kwargs) of tests/test_decoder.py
def _penalized():
    fst = two_word_graph()
    fst.states[0].arcs[0].weight = 3.0
    return fst


VITERBI_CASES = {
    "single_word": (two_word_graph, loglikes_for([1, 2]), {}),
    "other_word": (two_word_graph, loglikes_for([3, 4]), {}),
    "word_sequence": (two_word_graph, loglikes_for([1, 2, 3, 4, 1, 2]), {}),
    "ambiguous_strong": (_penalized, loglikes_for([1, 2], good=10.0), {}),
    "ambiguous_weak": (_penalized, loglikes_for([1, 2], good=1.0), {}),
    "acoustic_scale": (_penalized, loglikes_for([1, 2], good=10.0),
                       {"acoustic_scale": 0.1}),
    "beam_pruning": (two_word_graph, loglikes_for([1, 2, 3, 4]),
                     {"beam": 1.0, "max_active": 2}),
    "random_graph": (lambda: random_eps_free_graph(seed=4),
                     np.random.default_rng(4).normal(size=(9, 12)), {}),
    "eps_graph": (lambda: random_eps_graph(seed=2),
                  np.random.default_rng(2).normal(size=(7, 8)),
                  {"beam": 1e9, "max_active": 10 ** 9}),
}


@pytest.mark.parametrize("case", VITERBI_CASES)
def test_token_passing_viterbi_equal(case):
    make, ll, opts = VITERBI_CASES[case]
    jg, pg = both_graphs(make())
    jr = jax_viterbi.ViterbiDecoder(
        jg, jax_viterbi.DecodeOptions(**opts)).decode(ll)
    pr = port_viterbi.ViterbiDecoder(
        pg, port_viterbi.DecodeOptions(**opts)).decode(ll)
    assert (pr.words, pr.alignment, pr.final_reached) == (
        jr.words, jr.alignment, jr.final_reached)
    np.testing.assert_allclose(pr.total_cost, jr.total_cost, atol=COST_ATOL,
                               rtol=0)


def test_token_passing_batch_equal():
    jg, pg = both_graphs(two_word_graph())
    lls = np.stack([loglikes_for([1, 2]), loglikes_for([3, 4])])
    jr = jax_viterbi.ViterbiDecoder(jg).decode_batch(lls)
    pr = port_viterbi.ViterbiDecoder(pg).decode_batch(lls)
    assert [r.words for r in pr] == [r.words for r in jr] == [[1], [2]]


def lattice_arrays(lat):
    aa = lat._arc_arrays()
    return {"num_nodes": lat.num_nodes, "node_frame": lat.node_frame,
            "final_cost": lat.final_cost, "src": aa.src, "dst": aa.dst,
            "ilabel": aa.ilabel, "olabel": aa.olabel,
            "graph_cost": aa.graph_cost, "acoustic_cost": aa.acoustic_cost}


def assert_lattices_equal(j, p):
    ja, pa = lattice_arrays(j), lattice_arrays(p)
    for name in ja:
        if name in ("final_cost", "graph_cost", "acoustic_cost"):
            np.testing.assert_allclose(pa[name], ja[name], atol=COST_ATOL,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(pa[name], ja[name], err_msg=name)


def assert_paths_equal(j, p):
    """Best paths and n-best lists: words equal, costs within 1e-6."""
    assert [w for w, _ in p] == [w for w, _ in j]
    np.testing.assert_allclose([c for _, c in p], [c for _, c in j],
                               atol=COST_ATOL, rtol=0)


def _bigram_ll():
    ll = np.zeros((4, 6))
    ll[0, 0] = 2.0; ll[1, 1] = 2.0
    ll[2, 0] = 1.1; ll[3, 1] = 1.1
    ll[2, 2] = 1.0; ll[3, 3] = 1.0
    return ll


def _scale_flip_graph():
    s = [FstState() for _ in range(5)]
    s[0].arcs.append(FstArc(1, 2.0, 1, olabel=0))
    s[1].arcs.append(FstArc(2, 0.0, 4, olabel=1))
    s[0].arcs.append(FstArc(3, 0.0, 2, olabel=0))
    s[2].arcs.append(FstArc(4, 0.0, 4, olabel=2))
    s[4].final = 0.0
    return Fst(start=0, states=s)


# (graph, loglikes, LatticeDecodeOptions kwargs) of tests/test_lattice.py
LATTICE_CASES = {
    "best_path": (two_word_graph, loglikes_for([1, 2, 3, 4]), {}),
    "ambiguous": (two_word_graph, ambiguous_loglikes(), {}),
    "ambiguous_tilt": (two_word_graph, ambiguous_loglikes(tilt=0.2), {}),
    "scale_flip": (_scale_flip_graph, ambiguous_loglikes(tilt=1.5),
                   {"beam": 50.0, "lattice_beam": 50.0}),
    "bigram": (two_word_graph, _bigram_ll(),
               {"beam": 50.0, "lattice_beam": 50.0}),
    "random": (lambda: random_eps_free_graph(seed=1),
               np.random.default_rng(11).normal(size=(7, 12)),
               {"beam": 1e9, "max_active": 10 ** 9, "lattice_beam": 6.0}),
}


def _both_lattices(case):
    make, ll, opts = LATTICE_CASES[case]
    fst = make()
    if isinstance(fst, Fst):          # built from the port's classes
        jg = jax_graph.DecodingGraph.from_fst(_jax_fst(fst))
        pg = port_graph.DecodingGraph.from_fst(fst)
    else:
        jg, pg = both_graphs(fst)
    jl = jax_lattice.LatticeDecoder(
        jg, jax_lattice.LatticeDecodeOptions(**opts)).decode(ll)
    pl = port_lattice.LatticeDecoder(
        pg, port_lattice.LatticeDecodeOptions(**opts)).decode(ll)
    return jl, pl


def _jax_fst(fst):
    from kaldi_fp16_tpu.io import fst as jfst
    return jfst.Fst(start=fst.start, states=[
        jfst.FstState(final=st.final, arcs=[
            jfst.FstArc(a.label, a.weight, a.next_state, olabel=a.olabel)
            for a in st.arcs]) for st in fst.states])


@pytest.mark.parametrize("case", LATTICE_CASES)
def test_lattice_decoder_equal(case):
    jl, pl = _both_lattices(case)
    assert_lattices_equal(jl, pl)
    assert pl.word_sequences() == jl.word_sequences()
    for scale in (1.0, 0.1):
        assert_paths_equal([jl.best_path(acoustic_scale=scale)],
                           [pl.best_path(acoustic_scale=scale)])
        assert_paths_equal(jl.n_best(4, acoustic_scale=scale),
                           pl.n_best(4, acoustic_scale=scale))
    assert_lattices_equal(jl.prune(1e-6), pl.prune(1e-6))
    assert_lattices_equal(jl.prune(1.5, acoustic_scale=0.5),
                          pl.prune(1.5, acoustic_scale=0.5))
    for ref in ([1], [2], [1, 2]):
        jr, pr = jl.oracle_wer(ref), pl.oracle_wer(ref)
        assert pr[1] == jr[1]
        np.testing.assert_allclose(pr[0], jr[0], atol=COST_ATOL)


@pytest.mark.parametrize("case", LATTICE_CASES)
def test_posteriors_and_ctm_equal(case):
    jl, pl = _both_lattices(case)
    np.testing.assert_allclose(pl.arc_posteriors(), jl.arc_posteriors(),
                               atol=COST_ATOL, rtol=0)
    for kw in ({}, {"frame_shift": 0.01, "acoustic_scale": 0.3}):
        jc, pc = jl.to_ctm(**kw), pl.to_ctm(**kw)
        assert [r[2] for r in pc] == [r[2] for r in jc]
        np.testing.assert_allclose([r[:2] + r[3:] for r in pc],
                                   [r[:2] + r[3:] for r in jc],
                                   atol=COST_ATOL, rtol=0)


LMS = {
    "unigram": ({(1,): 10.0, (2,): 0.1}, {}, 1),
    "bigram": ({(1,): 0.5, (2,): 0.5, (1, 1): 8.0, (1, 2): 0.1, (2, 1): 1.0,
                (2, 2): 1.0}, {}, 2),
    "backoff": ({(1,): 2.0, (1, 2): 0.5}, {(2,): 1.5}, 2),
}


@pytest.mark.parametrize("lm_name", LMS)
@pytest.mark.parametrize("case", ["ambiguous", "bigram", "random"])
def test_lm_rescoring_equal(lm_name, case):
    ngrams, backoffs, order = LMS[lm_name]
    jl, pl = _both_lattices(case)
    jlm = jax_lattice.NGramLM(ngrams, backoffs=backoffs, order=order)
    plm = port_lattice.NGramLM(ngrams, backoffs=backoffs, order=order)
    for ctx, w in (((), 1), ((1,), 2), ((2,), 1), ((7,), 5), ((), 12345)):
        assert plm.cost(ctx, w) == jlm.cost(ctx, w)
    for kw in ({}, {"lm_weight": 0.5, "old_lm_weight": 1.0}):
        jr = jax_lattice.rescore_with_lm(jl, jlm, **kw)
        pr = port_lattice.rescore_with_lm(pl, plm, **kw)
        assert_lattices_equal(jr, pr)
        assert_paths_equal([jr.best_path()], [pr.best_path()])
        assert_paths_equal(jr.n_best(3), pr.n_best(3))


def test_arc_array_lattices_equal():
    """The vectorized (ArcArrays) paths of a random eps-free lattice."""
    rng = np.random.default_rng(5)
    T, S = 6, 5
    frames = np.concatenate([[0], np.repeat(np.arange(1, T + 1), S)])
    rows = []
    for f in range(T):
        srcs = [0] if f == 0 else [1 + (f - 1) * S + s for s in range(S)]
        for src in srcs:
            for s2 in rng.choice(S, size=3, replace=False):
                rows.append((src, 1 + f * S + int(s2), int(rng.integers(1, 9)),
                             int(rng.integers(0, 4)),
                             float(rng.uniform(0, 2)),
                             float(rng.uniform(-1, 1))))
    final = np.full(T * S + 1, np.inf)
    final[1 + (T - 1) * S:] = rng.uniform(0, 1, S)
    lats = []
    for mod in (jax_lattice, port_lattice):
        arcs = mod.ArcArrays.from_arcs([mod.LatticeArc(*r) for r in rows])
        lats.append(mod.Lattice(num_nodes=T * S + 1, arcs=arcs,
                                final_cost=final, node_frame=frames))
    jl, pl = lats
    assert pl._is_eps_free() and jl._is_eps_free()
    for scale in (1.0, 0.3):
        assert_paths_equal([jl.best_path(acoustic_scale=scale)],
                           [pl.best_path(acoustic_scale=scale)])
        np.testing.assert_allclose(pl._backward_costs(scale, 1.0),
                                   jl._backward_costs(scale, 1.0),
                                   atol=COST_ATOL)
    assert_lattices_equal(jl.prune(1.5), pl.prune(1.5))
    assert_paths_equal(jl.n_best(4), pl.n_best(4))


@pytest.fixture
def arpa(tmp_path):
    p = tmp_path / "lm.arpa"
    p.write_text(test_lattice.TestArpa.ARPA)
    w = tmp_path / "words.txt"
    w.write_text("<eps> 0\none 1\ntwo 2\n")
    return str(p), str(w)


@pytest.mark.parametrize("with_table", [False, True])
def test_arpa_and_symbol_tables_equal(arpa, with_table):
    path, words = arpa
    jsyms = jax_lm.read_symbol_table(words) if with_table else None
    psyms = port_lm.read_symbol_table(words) if with_table else None
    assert psyms == jsyms
    jlm, jmap = jax_lm.read_arpa(path, jsyms)
    plm, pmap = port_lm.read_arpa(path, psyms)
    assert pmap == jmap
    assert plm.order == jlm.order and plm.ngrams == jlm.ngrams
    assert plm.backoffs == jlm.backoffs
    ids = sorted(jmap.values())
    for ctx in [()] + [(i,) for i in ids]:
        for w in ids:
            assert plm.cost(ctx, w) == jlm.cost(ctx, w)
    seq = [jmap["one"], jmap["two"]]
    for kw in ({}, {"bos": jmap["<s>"], "eos": jmap["</s>"]}):
        assert port_lm.sentence_cost(plm, seq, **kw) == \
            jax_lm.sentence_cost(jlm, seq, **kw)


WER_CASES = [
    ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 9, 3]), ([1, 2], [1, 2, 3]),
    ([1, 2, 3], [1, 3]), (["a", "b"], []), ([], ["a"]),
    (list(range(12)), [0, 2, 2, 5, 7, 8, 11, 13]),
]


@pytest.mark.parametrize("ref,hyp", WER_CASES)
def test_levenshtein_equal(ref, hyp):
    assert port_wer.levenshtein(ref, hyp) == jax_wer.levenshtein(ref, hyp)


def test_wer_report_equal():
    refs = [r for r, _ in WER_CASES]
    hyps = [h for _, h in WER_CASES]
    assert port_wer.wer(refs, hyps) == jax_wer.wer(refs, hyps)
    assert port_wer.wer([["a", "b"]], [[]]) == jax_wer.wer([["a", "b"]], [[]])
