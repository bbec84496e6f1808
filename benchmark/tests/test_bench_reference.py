"""The reference against the port, at tiny sizes on the CPU: with the
program computing in float32 the two agree to float32 rounding through the
three steps they share, in both drivers (the recipe's loader, NG-SGD, loss
scaling and xent; the step's cut convs, attention and momentum), and on
the chain objective of the program's own step-1 output."""

import argparse
import json
import time

import numpy as np
import pytest
import torch

import tiny
from benchmark.harness import core


def fp32_root(tmp_path, cells=None):
    root = tiny.make_root(tmp_path, cells)
    cfg = dict(tiny.CONFIG, compute_dtype="float32")
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    return root


def run(root, cell, seed=2**40 + 3, trace=0):
    spec = core.cell_spec(cell, root)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5,
                              trace=trace)
    return core.run_cell(spec, args, torch.device("cpu"), time.time())


@pytest.mark.parametrize("cell", ["tiny.recipe", "tiny.step"])
def test_reference_follows_the_port(tmp_path, two_threads, cell):
    res = run(fp32_root(tmp_path), cell)
    gaps = {k: v["value"] for k, v in res["checks"].items()}
    assert max(gaps.values()) < 2e-5, gaps
    from benchmark.harness.training import NUMBERS
    assert set(gaps) == set(NUMBERS)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0


def test_phone_lm_is_the_ports():
    from kaldi_fp16_tpu_torch.chain.graph import make_phone_lm_den_fst
    from benchmark.traffic.phone_lm import phone_lm_arcs
    a = phone_lm_arcs(num_pdfs=40, num_phones=30, branching=6, seed=4)
    f = make_phone_lm_den_fst(num_pdfs=40, num_phones=30, branching=6, seed=4)
    arcs = [(s, x.label, x.weight, x.next_state)
            for s, st in enumerate(f.states) for x in st.arcs]
    assert arcs == list(zip(a["src"].tolist(), a["label"].tolist(),
                            a["weight"].tolist(), a["dst"].tolist()))


def test_den_is_the_oracles():
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.graph import make_phone_lm_den_fst
    from kaldi_fp16_tpu_torch.chain.reference import (
        denominator_forward_backward_ref,
    )
    from benchmark.reference.chain import DenGraph, den_forward_backward
    from benchmark.traffic.phone_lm import phone_lm_arcs
    a = phone_lm_arcs(num_pdfs=10, num_phones=6, branching=3, seed=1)
    g = DenGraph.from_arcs(a["src"], a["dst"], a["label"] - 1, a["weight"],
                           a["states"], a["start"], "cpu")
    port = DenominatorGraph.from_fst(make_phone_lm_den_fst(
        num_pdfs=10, num_phones=6, branching=3, seed=1), 10)
    x = np.random.default_rng(0).normal(size=(2, 7, 10))
    lp, post = den_forward_backward(g, torch.as_tensor(x), 1e-5)
    for b in range(2):
        lp_ref, post_ref = denominator_forward_backward_ref(port, x[b], 1e-5)
        assert float(lp[b]) == pytest.approx(lp_ref, rel=1e-9)
        np.testing.assert_allclose(post[b].numpy(), post_ref, atol=1e-10)


def test_cm_round_trips_are_the_ports():
    from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter
    from kaldi_fp16_tpu_torch.io import matrix
    from benchmark.reference.cm import cm2_round_trip, cm_round_trip
    import io
    x = (np.random.default_rng(2).normal(size=(30, 8)) * 0.3).astype(
        np.float32)
    x[3:6, 2] += 2.0
    for write, read, mine, tok in (
            (matrix.write_compressed_matrix_cm,
             matrix.read_compressed_matrix_cm, cm_round_trip, "CM"),
            (matrix.write_compressed_matrix_cm2,
             matrix.read_compressed_matrix_cm2, cm2_round_trip, "CM2")):
        buf = io.BytesIO()
        write(BinaryWriter(buf), x)
        r = BinaryReader(io.BytesIO(buf.getvalue()))
        assert r.read_token() == tok
        np.testing.assert_array_equal(read(r), mine(x))
