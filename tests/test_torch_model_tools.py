"""The port's model tools against the JAX package's: `tools.modeltools`
(info / copy / compare), `tools.loadtest` and `tools.nnettest`.

* modeltools: text -> binary -> text through the port's tool has zero
  diff; `info` prints what tools/modeltools.py prints, and `copy` writes
  the same bytes, on the same files.
* loadtest: the round trip (export -> text -> .raw -> load) gives the
  exported network's forward bit for bit; `--model` loads a JAX-written
  model; the lines up to the load report equal tools/loadtest.py's (the
  outputs' values differ: each tool draws its own random weights); with
  no --device it goes to the card, and raises here.
* nnettest prints what tools/nnettest.py prints.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import jax

from kaldi_fp16_tpu.models import kaldi_loader as jl
from kaldi_fp16_tpu.models import network as jax_net
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu_torch.tools import loadtest, modeltools, nnettest
from tests.test_torch_network import NARROW

ROOT = Path(__file__).resolve().parents[1]


def run_jax_tool(script, *args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "KALDI_TPU_NO_COMPILE_CACHE": "1"})
    return proc


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-exported nnet3 text model (NARROW, seed 0), its .raw written
    by the JAX modeltools, and the xconfig."""
    d = tmp_path_factory.mktemp("models")
    jm = jax_build_from_string(NARROW)
    params, state = jax_net.init_params(jm, jax.random.PRNGKey(0))
    (d / "m.txt").write_text(jl.export_params_to_text(jm, params, state))
    (d / "narrow.xconfig").write_text(NARROW)
    proc = run_jax_tool("modeltools.py", "copy", str(d / "m.txt"),
                        str(d / "jax.raw"), "--binary")
    assert proc.returncode == 0, proc.stderr
    return d


def test_modeltools_round_trip_has_zero_diff(files, capsys):
    d = files
    assert modeltools.main(["copy", str(d / "m.txt"), str(d / "p.raw"),
                            "--binary"]) == 0
    assert (d / "p.raw").read_bytes() == (d / "jax.raw").read_bytes()
    assert modeltools.main(["copy", str(d / "p.raw"), str(d / "p2.txt"),
                            "--text"]) == 0
    capsys.readouterr()
    assert modeltools.main(["compare", str(d / "m.txt"),
                            str(d / "p2.txt")]) == 0
    out = capsys.readouterr().out
    assert "worst |diff| = 0.000e+00" in out
    proc = run_jax_tool("modeltools.py", "copy", str(d / "p.raw"),
                        str(d / "j2.txt"), "--text")
    assert proc.returncode == 0, proc.stderr
    assert (d / "p2.txt").read_text() == (d / "j2.txt").read_text()


@pytest.mark.parametrize("which", ["m.txt", "jax.raw"])
def test_modeltools_info_prints_what_the_jax_tool_prints(files, which,
                                                         capsys):
    path = str(files / which)
    assert modeltools.main(["info", path]) == 0
    ours = capsys.readouterr().out
    assert ("binary container" in ours) == which.endswith(".raw")
    proc = run_jax_tool("modeltools.py", "info", path)
    assert proc.returncode == 0, proc.stderr
    assert ours == proc.stdout


def test_modeltools_compare_finds_a_difference(files, capsys):
    d = files
    text = (d / "m.txt").read_text()
    (d / "bad.txt").write_text(text.replace(
        "<ComponentName> output.affine", "<ComponentName> output.affine "
        "<LearningRate> 0.5", 1))
    assert modeltools.main(["compare", str(d / "m.txt"),
                            str(d / "bad.txt")]) == 1
    assert "output.affine.learning_rate" in capsys.readouterr().out


@pytest.mark.parametrize("model", [None, "m.txt", "jax.raw"])
def test_loadtest_holds_the_round_trip_and_prints_the_jax_lines(
        files, model, capsys):
    d = files
    args = ["--xconfig", str(d / "narrow.xconfig")]
    if model:
        args += ["--model", str(d / model)]
    res = loadtest.main(args + ["--device", "cpu"])
    ours = capsys.readouterr().out
    assert res["failures"] == 0 and ours.rstrip().endswith("PASS")
    assert res["outputs"] == {"output": (2, 30, 10),
                              "output-xent": (2, 30, 10)}
    if model is None:
        assert res["round_trip_max_abs_err"] == 0.0
        assert "round-trip forward max |err| = 0.00e+00" in ours
    proc = run_jax_tool("loadtest.py", *args)
    assert proc.returncode == 0, proc.stderr
    head = ours.split("\noutput ")[0]
    assert head == proc.stdout.split("\noutput ")[0]
    assert f"loaded {sum(res['report'].values()):,} values into 13 layers" \
        in head


def test_loadtest_goes_to_the_card_by_default(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadtest.main(["--xconfig", str(files / "narrow.xconfig")])


def test_nnettest_prints_what_the_jax_tool_prints(capsys):
    model = nnettest.main([])
    ours = capsys.readouterr().out
    proc = run_jax_tool("nnettest.py")
    assert proc.returncode == 0, proc.stderr
    assert ours == proc.stdout
    assert model.chain_output().name == "output"
    assert "attention" not in ours
