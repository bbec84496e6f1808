"""The twins of tools/synthwer.py and tools/streambench.py against the JAX
tools.

synthwer: the copied data helpers equal the JAX tool's from the same seed
(lexica, pdf sequences, features, the cegs ark written from them, the two
FSTs, the ARPA text); the acoustic pass on JAX weights lies within the
fp32 network bar of JAX's (1e-4, tests/test_torch_network.py) and decodes
to the same words; the CPU smoke run passes the JAX smoke test's gate
(tests/test_tools.py:85-96).

streambench: the graphs it decodes equal the ones the JAX tool builds
(captured from the JAX tool's own run), and tiny decode-only and encoder
runs print rows with the JAX tool's keys.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.decode import streaming as jax_streaming
from kaldi_fp16_tpu.decode.graph import DecodingGraph as JaxGraph
from kaldi_fp16_tpu.decode.tpu_viterbi import (
    SparseViterbiDecoder as JaxSparse,
)
from kaldi_fp16_tpu.io.egs import write_ark as jax_write_ark
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.decode.device_viterbi import SparseViterbiDecoder
from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
from kaldi_fp16_tpu_torch.io.egs import write_ark
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import Network
from kaldi_fp16_tpu_torch.tools import streambench, synthwer
from tests.test_streaming import XCONFIG as TINY_XCONFIG
from tests.test_torch_decode_host import assert_graphs_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP32 = dict(rtol=1e-4, atol=1e-4)          # tests/test_torch_network.py


def load_jax_tool(monkeypatch, name):
    """tools/<name>.py as a module (it imports tools/_common)."""
    monkeypatch.setenv("KALDI_TPU_NO_COMPILE_CACHE", "1")
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jsw(monkeypatch):
    return load_jax_tool(monkeypatch, "synthwer")


def tool_args(**kw):
    base = dict(words_per_utt=3, dur=2, zipf=0.0, max_dur=0, phones=12,
                noise=0.5)
    return SimpleNamespace(**{**base, **kw})


def fst_arcs(fst):
    return (fst.start, [(s.final, [(a.label, a.weight, a.next_state,
                                    a.olabel) for a in s.arcs])
                        for s in fst.states])


# -- synthwer -------------------------------------------------------------

@pytest.mark.parametrize("disjoint", [True, False])
def test_lexicon_and_utterances_equal_the_jax_tool(jsw, disjoint):
    r_j, r_p = np.random.default_rng(3), np.random.default_rng(3)
    lex = synthwer.make_lexicon(r_p, 10, 5, 2, disjoint=disjoint)
    assert lex == jsw.make_lexicon(r_j, 10, 5, 2, disjoint=disjoint)
    means = r_p.normal(size=(10, 6)).astype(np.float32)
    assert np.array_equal(means, r_j.normal(size=(10, 6)).astype(np.float32))
    for zipf, max_dur in ((0.0, 0), (1.2, 4)):
        ws_p, pdfs_p = synthwer.sample_utt(r_p, lex, 4, 2, zipf, max_dur)
        ws_j, pdfs_j = jsw.sample_utt(r_j, lex, 4, 2, zipf, max_dur)
        assert ws_p == ws_j
        np.testing.assert_array_equal(pdfs_p, pdfs_j)
        np.testing.assert_array_equal(
            synthwer.features_for(r_p, pdfs_p, means, 0.5),
            jsw.features_for(r_j, pdfs_j, means, 0.5))


def test_examples_write_the_jax_tool_ark(jsw, tmp_path):
    """make_example from the same seed: the same words, and the cegs arks
    written from the port's and the JAX tool's examples are byte-equal."""
    args = tool_args(max_dur=4, zipf=1.2)
    lex = {1: (0, 1), 2: (2, 3), 3: (4, 5)}
    means = np.random.default_rng(0).normal(size=(12, 5)).astype(np.float32)
    r_j, r_p = np.random.default_rng(4), np.random.default_rng(4)
    pairs_p = [synthwer.make_example(r_p, f"utt{i}", lex, args, means)
               for i in range(4)]
    pairs_j = [jsw.make_example(r_j, f"utt{i}", lex, args, means)
               for i in range(4)]
    assert [w for _, w in pairs_p] == [w for _, w in pairs_j]
    write_ark(str(tmp_path / "p.ark"), [e for e, _ in pairs_p])
    jax_write_ark(str(tmp_path / "j.ark"), [e for e, _ in pairs_j])
    assert (tmp_path / "p.ark").read_bytes() == (tmp_path / "j.ark").read_bytes()


@pytest.mark.parametrize("phones", [3, 12])
def test_fsts_equal_the_jax_tool(jsw, phones):
    assert fst_arcs(synthwer.bigram_den_fst(phones)) == fst_arcs(
        jsw.bigram_den_fst(phones))
    lex = synthwer.make_lexicon(np.random.default_rng(phones), phones,
                                phones // 3, 2, disjoint=False)
    assert fst_arcs(synthwer.word_loop_fst(lex)) == fst_arcs(
        jsw.word_loop_fst(lex))


def test_arpa_equals_the_jax_tool(jsw, tmp_path):
    refs = [[1, 2, 3], [3, 3], [2], [1, 4, 4, 2]]
    synthwer.write_arpa(str(tmp_path / "p.arpa"), refs, 4)
    jsw.write_arpa(str(tmp_path / "j.arpa"), refs, 4)
    assert (tmp_path / "p.arpa").read_bytes() == \
        (tmp_path / "j.arpa").read_bytes()


def test_acoustic_pass_matches_jax_and_decodes_alike(jsw):
    """The twin's acoustic pass on JAX weights against the JAX tool's
    (network.forward in fp32, subsample_output), and both through the
    word-loop graph."""
    xconfig = synthwer.build_xconfig(24, 12)
    assert xconfig == jsw.build_xconfig(24, 12)
    jm = jax_build_from_string(xconfig)
    params, state = jax_net.Network(jm).init(jax.random.PRNGKey(0))
    pm = build_model_from_string(xconfig)
    net = Network(pm, torch.Generator(), device="cpu")
    net.load_state_dict(params_from_jax(pm, params, state), strict=True)
    rng = np.random.default_rng(5)
    lex = synthwer.make_lexicon(rng, 12, 6, 2)
    means = rng.normal(size=(12, 24)).astype(np.float32) * 1.5
    args = tool_args()
    feats = np.stack([synthwer.make_example(rng, f"utt{i}", lex, args,
                                            means)[0].inputs[0].data
                      for i in range(3)])
    fps = 12
    got = synthwer.acoustic(net, torch.from_numpy(feats), fps).numpy()
    outs, _ = jax_net.forward(jm, params, state, jnp.asarray(feats), None,
                              train=False, compute_dtype=jnp.float32)
    ref = np.asarray(jax_net.subsample_output(
        outs[jm.chain_output().name], synthwer.STRIDE, synthwer.LEFT, fps))
    assert got.shape == ref.shape == (3, fps, 12)
    np.testing.assert_allclose(got, ref, **FP32)
    fst = synthwer.word_loop_fst(lex)
    words_p = [r["words"] for r in SparseViterbiDecoder(
        DecodingGraph.from_fst(fst), device="cpu").decode_batch(got)]
    words_j = [r["words"] for r in JaxSparse(
        JaxGraph.from_fst(jsw.word_loop_fst(lex))).decode_batch(ref)]
    assert words_p == words_j


def test_synthwer_smoke(capsys):
    """The JAX smoke test's run and gate (tests/test_tools.py:85-96)."""
    out = synthwer.main(["--device", "cpu", "--steps", "45",
                         "--train-utts", "96", "--test-utts", "12",
                         "--eval-every", "15", "--lm-rescore",
                         "--streaming"])
    printed = capsys.readouterr().out
    assert out["ok"] is True
    assert '"ok": true' in printed
    assert '"lm_rescore"' in printed      # ARPA write -> read -> rescore ran
    assert '"streaming"' in printed       # windowed online decode ran
    assert out["steps"] == 45 and [h["step"] for h in out["history"]] == [
        0, 15, 30, 45]
    assert out["wer_final"] <= 0.05 < out["wer_first"]


def test_synthwer_raises_without_a_device_on_a_cpu_box():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthwer.main(["--steps", "1"])


# -- streambench ----------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.mark.parametrize("flags", [
    ["--graph-states", "40", "--graph-arcs", "150", "--pdfs", "12"],
    ["--hclg", "--graph-states", "203", "--pdfs", "30"]],
    ids=["random", "hclg"])
def test_streambench_graphs_equal_the_jax_tool(monkeypatch, flags):
    """The JAX tool's graph, captured where it builds its decoder."""
    jsb = load_jax_tool(monkeypatch, "streambench")
    seen = []

    def capture(graph, **kw):
        seen.append(graph)
        raise _Captured

    monkeypatch.setattr(jax_streaming, "StreamingDecoder", capture)
    monkeypatch.setattr(sys, "argv", ["streambench.py", "--decode-only",
                                      *flags])
    with pytest.raises(_Captured):
        jsb.main()
    args = streambench.parse_args(flags)
    assert_graphs_equal(seen[0], streambench.bench_graph(
        args, np.random.default_rng(0)))


def run_jax_streambench(*flags):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "streambench.py"), *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "KALDI_TPU_NO_COMPILE_CACHE": "1"})
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


SMALL = ["--batch", "2", "--graph-states", "64", "--graph-arcs", "256",
         "--pdfs", "6", "--iters", "1"]


@pytest.mark.parametrize("decoder", ["incremental", "windowed"])
def test_streambench_decode_only_rows(decoder, capsys):
    flags = SMALL + ["--decode-only", "--chunks", "2,5", "--decoder",
                     decoder, "--window", "8"]
    rows = streambench.main(flags + ["--device", "cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == 2
    ref = run_jax_streambench(*flags)
    for row, jrow in zip(rows, ref):
        assert set(row) == set(jrow)
        for key in ("decoder", "chunk_out", "batch", "graph",
                    "window_frames", "committed_frames", "bp_window_mb"):
            assert row.get(key) == jrow.get(key), key


def test_streambench_encoder_rows(tmp_path, capsys):
    xconfig = tmp_path / "tiny.xconfig"
    xconfig.write_text(TINY_XCONFIG)
    flags = SMALL + ["--chunks", "2,4", "--xconfig", str(xconfig)]
    rows = streambench.main(flags + ["--device", "cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == 2
    ref = run_jax_streambench(*flags)
    for row, jrow in zip(rows, ref):
        assert set(row) == set(jrow)
        for key in ("chunk_out", "chunk_in", "batch", "ctx", "lag_chunks",
                    "algorithmic_latency_ms", "graph", "decoder"):
            assert row[key] == jrow[key], key
        assert row["encoder_ms_per_chunk"] > 0 and row["e2e_ms_per_chunk"] > 0


def test_streambench_raises_without_a_device_on_a_cpu_box():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streambench.main(SMALL + ["--decode-only"])
