"""The port's copies of the Kaldi I/O modules against the JAX package's.

kaldi_io, matrix, fst, egs (and the synthetic-egs tool) are numpy copies:
for the same inputs the port's writers must emit the same bytes, and its
readers must return the same values (exactly: no arithmetic differs).
The port's native parser binding must agree with its Python reader and
with the JAX package's native reader, and `best_reader` must keep the
JAX semantics (native when the library loads, Python for .gz).
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kaldi_fp16_tpu.io import egs as jegs
from kaldi_fp16_tpu.io import fst as jfst
from kaldi_fp16_tpu.io import kaldi_io as jkio
from kaldi_fp16_tpu.io import matrix as jmat
from kaldi_fp16_tpu.io import native as jnative
from kaldi_fp16_tpu_torch.io import egs as pegs
from kaldi_fp16_tpu_torch.io import fst as pfst
from kaldi_fp16_tpu_torch.io import kaldi_io as pkio
from kaldi_fp16_tpu_torch.io import matrix as pmat
from kaldi_fp16_tpu_torch.io import native as pnative

ROOT = Path(__file__).resolve().parents[1]
PAIRS = {"jax": (jegs, jfst, jkio, jmat), "port": (pegs, pfst, pkio, pmat)}


def make_fst(fst_mod, rng, n_states=6, n_pdfs=8):
    states = [fst_mod.FstState() for _ in range(n_states)]
    for s in range(n_states - 1):
        for _ in range(int(rng.integers(1, 4))):
            states[s].arcs.append(fst_mod.FstArc(
                int(rng.integers(1, n_pdfs + 1)),
                float(np.float32(rng.uniform(0, 3))),
                int(rng.integers(s + 1, n_states))))
    states[-1].final = float(np.float32(rng.uniform(0, 1)))
    return fst_mod.Fst(start=0, states=states)


def make_example(pkg, seed, key="utt-0001", frames=12, fps=4,
                 fmts=("CM", "CM2"), dw_fmt="DW2"):
    """One example built from `pkg`'s classes out of seeded numpy data."""
    egs, fst_mod = PAIRS[pkg][:2]
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(frames, 40)).astype(np.float32)
    ivec = rng.normal(size=(1, 100)).astype(np.float32)
    dw = rng.uniform(size=fps).astype(np.float32)
    sup = egs.Supervision(
        name="output", weight=float(np.float32(rng.uniform(0.5, 1.5))),
        num_sequences=1, frames_per_seq=fps, label_dim=8, end2end=False,
        fst=make_fst(fst_mod, rng),
        indexes=[egs.Index(0, t * 3, 0) for t in range(fps)],
        deriv_weights=dw, deriv_weights_fmt=dw_fmt)
    return egs.Example(key=key, inputs=[
        egs.IoBlock("input", [egs.Index(0, t - 3, 0) for t in range(frames)],
                    feats, fmts[0]),
        egs.IoBlock("ivector", [egs.Index(0, 0, 0)], ivec, fmts[1]),
    ], supervision=sup)


def flat_fst(f):
    if f is None:
        return None
    return (f.start, [(st.final, [(a.label, a.olabel, a.weight, a.next_state)
                                  for a in st.arcs]) for st in f.states])


def flat_example(ex):
    """An Example of either package as plain Python / numpy values."""
    sup = ex.supervision
    return {
        "key": ex.key,
        "inputs": [(io.name, [(i.n, i.t, i.x) for i in io.indexes], io.fmt,
                    np.asarray(io.data)) for io in ex.inputs],
        "sup": (sup.name, sup.weight, sup.num_sequences, sup.frames_per_seq,
                sup.label_dim, sup.end2end, sup.deriv_weights_fmt,
                [(i.n, i.t, i.x) for i in sup.indexes]),
        "dw": None if sup.deriv_weights is None else np.asarray(
            sup.deriv_weights),
        "fst": flat_fst(sup.fst),
    }


def assert_examples_equal(a, b):
    fa, fb = flat_example(a), flat_example(b)
    assert fa["key"] == fb["key"] and fa["sup"] == fb["sup"]
    assert fa["fst"] == fb["fst"]
    if fa["dw"] is None:
        assert fb["dw"] is None
    else:
        np.testing.assert_array_equal(fa["dw"], fb["dw"])
    assert len(fa["inputs"]) == len(fb["inputs"])
    for (na, ia, fma, da), (nb, ib, fmb, db) in zip(fa["inputs"],
                                                    fb["inputs"]):
        assert (na, ia, fma) == (nb, ib, fmb)
        np.testing.assert_array_equal(da, db)


def test_binary_primitives_write_the_same_bytes():
    out = []
    for kio in (jkio, pkio):
        w = kio.BinaryWriter()
        w.write_ark_record_header("utt-7")
        w.write_token("<Tag>")
        w.write_basic_int(-12345)
        w.write_float32(1.5)
        w.write_int64(2 ** 40)
        w.write_uint32(7)
        w.write_bytes(b"xyz")
        out.append(w.getvalue())
    assert out[0] == out[1]
    r = pkio.BinaryReader(out[1])
    assert r.read_bytes(8) == b"utt-7 \x00B"
    assert r.read_token() == "<Tag>"
    assert r.read_basic_int() == -12345


@pytest.mark.parametrize("fmt", ["CM", "CM2", "CM3", "FM", "SM"])
def test_matrix_codecs_equal(fmt):
    rng = np.random.default_rng(11)
    data = rng.normal(size=(17, 9)).astype(np.float32)
    if fmt == "SM":
        data = np.where(rng.uniform(size=data.shape) < 0.3, data, 0.0) \
            .astype(np.float32)
    writers = {"CM": "write_compressed_matrix_cm",
               "CM2": "write_compressed_matrix_cm2",
               "CM3": "write_compressed_matrix_cm3",
               "FM": "write_full_matrix", "SM": "write_sparse_matrix"}
    readers = {"CM": "read_compressed_matrix_cm",
               "CM2": "read_compressed_matrix_cm2",
               "CM3": "read_compressed_matrix_cm3",
               "FM": "read_full_matrix", "SM": "read_sparse_matrix"}
    blobs = []
    for kio, mat in ((jkio, jmat), (pkio, pmat)):
        w = kio.BinaryWriter()
        getattr(mat, writers[fmt])(w, data)
        blobs.append(w.getvalue())
    assert blobs[0] == blobs[1]
    got = []
    for kio, mat in ((jkio, jmat), (pkio, pmat)):
        r = kio.BinaryReader(blobs[0])
        assert r.read_token() == fmt          # the writers emit the token
        got.append(getattr(mat, readers[fmt])(r))
    if fmt == "SM":
        got = [g.to_dense() for g in got]
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("kind", ["vector", "compact_acceptor"])
def test_fst_read_write_equal(tmp_path, kind):
    blobs = []
    for pkg in ("jax", "port"):
        fst_mod, kio = PAIRS[pkg][1], PAIRS[pkg][2]
        f = make_fst(fst_mod, np.random.default_rng(5), n_states=9)
        w = kio.BinaryWriter()
        (fst_mod.write_fst_vector if kind == "vector"
         else fst_mod.write_fst_compact_acceptor)(w, f)
        blobs.append(w.getvalue())
        fst_mod.write_fst_file(str(tmp_path / f"{pkg}.fst"), f, fmt=kind)
    assert blobs[0] == blobs[1]
    assert (tmp_path / "jax.fst").read_bytes() == \
        (tmp_path / "port.fst").read_bytes()
    a = jfst.read_fst(jkio.BinaryReader(blobs[0]))
    b = pfst.read_fst(pkio.BinaryReader(blobs[0]))
    assert flat_fst(a) == flat_fst(b) and b.properties == a.properties
    assert flat_fst(pfst.read_fst_file(str(tmp_path / "port.fst"))) == \
        flat_fst(a)
    assert pfst.read_fst(pkio.BinaryReader(b"\x00" * 32)) is None


@pytest.mark.parametrize("fmts,dw_fmt", [(("CM", "CM2"), "DW2"),
                                         (("CM3", "FM"), "DW"),
                                         (("SM", "CM"), "DW2")])
def test_egs_write_read_equal(tmp_path, fmts, dw_fmt):
    paths = {}
    for pkg in ("jax", "port"):
        exs = [make_example(pkg, seed=i, key=f"utt-{i:04d}", fmts=fmts,
                            dw_fmt=dw_fmt) for i in range(5)]
        paths[pkg] = str(tmp_path / f"{pkg}.ark")
        PAIRS[pkg][0].write_ark(paths[pkg], exs)
    blob = Path(paths["jax"]).read_bytes()
    assert blob == Path(paths["port"]).read_bytes()
    jexs = jegs.read_examples(paths["port"])
    pexs = pegs.read_examples(paths["port"])
    assert len(pexs) == 5
    for a, b in zip(jexs, pexs):
        assert_examples_equal(a, b)
    assert pegs.count_examples(paths["port"]) == \
        jegs.count_examples(paths["jax"]) == 5
    # gzip: count and read through the same paths
    gz = tmp_path / "port.ark.gz"
    gz.write_bytes(gzip.compress(blob))
    assert pegs.count_examples(str(gz)) == 5
    assert [e.key for e in pegs.read_examples(str(gz))] == \
        [e.key for e in pexs]
    assert pegs.example_to_text(pexs[0]) == jegs.example_to_text(jexs[0])


def test_native_reader_matches_python_and_jax(tmp_path):
    if not pnative.native_available():
        pytest.skip("no native cegs parser library and no g++ to build it")
    path = str(tmp_path / "a.ark")
    exs = [make_example("port", seed=i, key=f"utt-{i:04d}",
                        fmts=(("CM", "CM2"), ("FM", "CM3"))[i % 2])
           for i in range(6)]
    pegs.write_ark(path, exs)
    with pnative.NativeEgsReader(path) as r:
        nat = list(r)
    py = pegs.read_examples(path)
    assert len(nat) == len(py) == 6
    for a, b in zip(nat, py):
        assert_examples_equal(a, b)
    if jnative.native_available():
        with jnative.NativeEgsReader(path) as r:
            for a, b in zip(list(r), nat):
                assert_examples_equal(a, b)
    # best_reader keeps the JAX semantics and says which reader it is
    r = pnative.best_reader(path)
    assert pnative.reader_kind(r) == "native"
    r.close()
    gz = tmp_path / "a.ark.gz"
    gz.write_bytes(gzip.compress(Path(path).read_bytes()))
    r = pnative.best_reader(str(gz))
    assert pnative.reader_kind(r) == "python"
    r.close()


def test_native_library_builds_from_source(tmp_path, monkeypatch):
    """Where the committed library does not load, the binding compiles
    cpp/cegs_parser.cpp into its build directory and loads that."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    monkeypatch.delenv("KALDI_FP16_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(pnative, "COMMITTED_LIB", tmp_path / "missing.so")
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_load_failed", False)
    assert pnative.native_available()
    assert list((tmp_path / "native").glob("*/libcegs_parser.so"))
    path = str(tmp_path / "b.ark")
    pegs.write_ark(path, [make_example("port", seed=3)])
    with pnative.NativeEgsReader(path) as r:
        assert_examples_equal(r.read_example(), pegs.read_examples(path)[0])


def test_synthetic_egs_tool_writes_the_same_bytes(tmp_path):
    """The port's make_synthetic_egs against tools/make_synthetic_egs.py."""
    from kaldi_fp16_tpu_torch.tools import make_synthetic_egs
    flags = ["--files", "2", "--per-file", "3", "--pdfs", "12",
             "--frames-in", "21", "--frames-out", "6", "--den-states", "12",
             "--den-topology", "phone-lm", "--seed", "4"]
    make_synthetic_egs.main([str(tmp_path / "port")] + flags)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               KALDI_TPU_NO_COMPILE_CACHE="1")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_egs.py"),
                    str(tmp_path / "jax")] + flags, check=True, env=env,
                   capture_output=True, timeout=120)
    for name in ("cegs.1.ark", "cegs.2.ark", "den.fst"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
