"""The port's denverify, sgdtest, chaintest, fwdtest and backtest twins
against the JAX package's tools, on the CPU.

* denverify prints tools/denverify.py's lines: the same oracle and
  brute-force values, the den's within the strict 2e-6; sgdtest prints
  tools/sgdtest.py's lines exactly.
* chaintest passes, and its model summary, den and batch lines equal the
  JAX tool's on the same cegs files.
* fwdtest's summary and output-shape lines equal the JAX tool's.
* backtest's `gradcheck`, handed the JAX init and jax.random's
  projection, gives jax.grad's gradients at tests/test_torch_network.py's
  fp32 bars (rtol / atol 1e-4) and passes its bar on all seven configs;
  the same tool with every matmul's backward scaled by 1.1 fails (the
  control).
"""

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_model,
)
from kaldi_fp16_tpu.models.network import forward as jax_forward
from kaldi_fp16_tpu.models.network import init_params as jax_init
from kaldi_fp16_tpu_torch.models import network as port_network
from kaldi_fp16_tpu_torch.tools import (
    backtest, chaintest, denverify, fwdtest, make_synthetic_egs, sgdtest,
)
from tests.test_torch_network import NARROW
from tests.test_torch_tool_help import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STRICT = 2e-6
GRAD_BARS = dict(rtol=1e-4, atol=1e-4)


def run_jax_tool(script, *args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "KALDI_TPU_NO_COMPILE_CACHE": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout.splitlines()


def test_denverify_prints_the_jax_tools_lines(capsys):
    res = denverify.main(["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    jax_lines = run_jax_tool("denverify.py")
    assert res["failures"] == 0 and len(port) == len(jax_lines)
    value = re.compile(r"(\w+)=(-?[\d.e+-]+)")
    for p, j in zip(port, jax_lines):
        if "logprob:" in p:
            pv, jv = dict(value.findall(p)), dict(value.findall(j))
            assert (pv["oracle"], pv["brute"]) == (jv["oracle"], jv["brute"])
            assert abs(float(pv["device"]) - float(jv["device"])) <= \
                STRICT + 1e-6
        elif "|device-oracle|" in p:
            assert p.split("|oracle-brute|=")[1].split()[0] == \
                j.split("|oracle-brute|=")[1].split()[0]
            assert p.split()[-1] == j.split()[-1] == "OK"
        else:
            assert p == j


def test_sgdtest_prints_the_jax_tools_lines(capsys):
    res = sgdtest.main(["--device", "cpu"])
    assert res["failures"] == 0 and len(res["checks"]) == 15
    assert capsys.readouterr().out.splitlines() == run_jax_tool("sgdtest.py")


@pytest.fixture(scope="module")
def egs(tmp_path_factory):
    d = tmp_path_factory.mktemp("egs")
    make_synthetic_egs.main([str(d), "--pdfs", "48"])
    return d


def test_chaintest_passes_with_the_jax_tools_summary(egs, capsys):
    argv = ["--egs", str(egs / "cegs.*.ark"), "--den-fst",
            str(egs / "den.fst")]
    res = chaintest.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    assert res["failures"] == 0 and all(res["ok"])
    assert res["deriv"]["nan"] == res["deriv"]["inf"] == 0
    jax_lines = run_jax_tool("chaintest.py", *argv)
    head = next(i for i, ln in enumerate(jax_lines)
                if ln.startswith("objf/frame"))
    assert port[:head] == jax_lines[:head]
    assert any(ln.startswith("den graph:") for ln in port[:head])
    assert port[-1] == jax_lines[-1] == "PASS"


def test_fwdtest_shapes_match_the_jax_tool(tmp_path, capsys):
    xc = tmp_path / "narrow.xconfig"
    xc.write_text(NARROW)
    argv = ["--xconfig", str(xc), "--batch", "2", "--frames", "30",
            "--iters", "1"]
    res = fwdtest.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    jax_lines = run_jax_tool("fwdtest.py", *argv)

    def shapes(lines):
        return [ln.split(" finite=")[0] for ln in lines
                if ln.startswith(("output ", "  ", "total params"))]

    assert shapes(port) == shapes(jax_lines)
    assert all(o["finite"] for o in res["outputs"].values())
    assert res["outputs"]["output"]["shape"] == (2, 30, 10)


def jax_gradients(cfg, rng):
    """The JAX tool's gradcheck set-up on `rng`'s draws: (params, state,
    projection, jax.grad of the loss), JAX layout, numpy."""
    model = jax_build_model(cfg)
    params, state = jax_init(model, jax.random.PRNGKey(1))
    B, T = 2, 8
    feats = rng.normal(size=(B, T, model.layer_map["input"].output_dim)
                       ).astype(np.float32)
    ivecs = (rng.normal(size=(B, model.layer_map["ivector"].output_dim))
             .astype(np.float32) if "ivector" in model.layer_map else None)

    def outputs(p):
        outs, _ = jax_forward(model, p, state, jnp.asarray(feats),
                              None if ivecs is None else jnp.asarray(ivecs),
                              train=False, compute_dtype=jnp.float32)
        return outs["output"].astype(jnp.float32)

    w = jax.random.normal(jax.random.PRNGKey(7), outputs(params).shape)
    grads = jax.grad(lambda p: jnp.sum(outputs(p) * w))(params)
    to_np = jax.tree_util.tree_map(np.asarray, (params, state, w, grads))
    return to_np


@pytest.mark.parametrize("name,cfg", backtest.CONFIGS,
                         ids=[n for n, _ in backtest.CONFIGS])
def test_backtest_gradients_equal_jax_grad(name, cfg):
    rng = np.random.default_rng(0)
    params, state, w, jgrads = jax_gradients(cfg, copy.deepcopy(rng))
    res = backtest.gradcheck(cfg, params, state, w, rng=rng, device="cpu")
    assert res["worst"] <= 2e-2, name
    assert set(res["grads"]) == set(jgrads)
    for lname, g in jgrads.items():
        for pname, jg in g.items():
            np.testing.assert_allclose(res["grads"][lname][pname], jg,
                                       err_msg=f"{name}: {lname}/{pname}",
                                       **GRAD_BARS)


def test_backtest_passes_on_the_cpu(capsys):
    res = backtest.main(["--device", "cpu"])
    assert res["failures"] == 0 and len(res["worst"]) == 7
    assert capsys.readouterr().out.strip().endswith("PASS")


class _ScaledBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.1 * g


def test_a_scaled_backward_fails_backtest(monkeypatch, capsys):
    matmul = port_network._matmul
    monkeypatch.setattr(
        port_network, "_matmul",
        lambda x, w, dtype: _ScaledBackward.apply(matmul(x, w, dtype)))
    res = backtest.main(["--device", "cpu", "--probes", "2"])
    out = capsys.readouterr().out
    assert res["failures"] > 0 and out.strip().startswith(
        "per-layer") and out.strip().splitlines()[-1].startswith("FAIL")
