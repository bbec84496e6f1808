"""The port's own copies of the FST classes and the CSR conversion
(kaldi_fp16_tpu_torch/io) against the JAX package's originals
(kaldi_fp16_tpu/io/fst.py, io/sparse.py), on the same FSTs: equal field
by field, and interchangeable (each conversion reads the other package's
FST objects)."""

import dataclasses

import numpy as np
import pytest

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.io import fst as jax_fst
from kaldi_fp16_tpu.io import sparse as jax_sparse
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.io import fst as port_fst
from kaldi_fp16_tpu_torch.io import sparse as port_sparse

FSTS = [
    pytest.param(lambda g: g.make_simple_den_fst(9, 6, seed=2), id="simple"),
    pytest.param(lambda g: g.make_phone_lm_den_fst(24, 13, 2, 4, seed=3),
                 id="phone-lm"),
]


def _csr_fields(csr):
    return {f.name: getattr(csr, f.name) for f in dataclasses.fields(csr)}


def _assert_csr_equal(a, b):
    fa, fb = _csr_fields(a), _csr_fields(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        np.testing.assert_array_equal(np.asarray(fa[name]),
                                      np.asarray(fb[name]), err_msg=name)
        if isinstance(fa[name], np.ndarray):
            assert fa[name].dtype == fb[name].dtype, name


@pytest.mark.parametrize("make", FSTS)
def test_port_fst_and_csr_equal_the_originals(make):
    jf, pf = make(jax_graph), make(port_graph)
    assert isinstance(pf, port_fst.Fst) and isinstance(jf, jax_fst.Fst)
    assert (pf.start, pf.num_states, pf.num_arcs, pf.properties) == \
        (jf.start, jf.num_states, jf.num_arcs, jf.properties)
    for ps, js in zip(pf.states, jf.states):
        assert (ps.final, ps.is_final) == (js.final, js.is_final)
        assert [dataclasses.astuple(a) for a in ps.arcs] == \
            [dataclasses.astuple(a) for a in js.arcs]
    _assert_csr_equal(port_sparse.fst_to_csr(pf), jax_sparse.fst_to_csr(jf))
    # each conversion reads the other package's FST objects alike
    _assert_csr_equal(port_sparse.fst_to_csr(jf), jax_sparse.fst_to_csr(jf))
    _assert_csr_equal(jax_sparse.fst_to_csr(pf), port_sparse.fst_to_csr(pf))


def test_port_arc_and_state_defaults_match():
    assert dataclasses.astuple(port_fst.FstArc(3, 0.5, 1)) == \
        dataclasses.astuple(jax_fst.FstArc(3, 0.5, 1))
    assert port_fst.FstArc(3, 0.5, 1, olabel=7).olabel == 7
    assert not port_fst.FstState().is_final and port_fst.FstState(0.0).is_final
    csr = port_sparse.fst_to_csr(port_graph.make_simple_den_fst(5, 4, seed=1))
    csr.validate()
    assert csr.label_dim() <= 5 and len(csr.src_states()) == csr.num_arcs
    with pytest.raises(ValueError):
        port_sparse.fst_to_csr(port_fst.Fst(start=0, states=[]))
