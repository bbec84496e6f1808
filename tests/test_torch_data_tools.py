"""The port's host data tools against the JAX package's, on the same
make_synthetic_egs files.

* egstools (every subcommand), nscheck and csrdump print the JAX tools'
  stdout (nscheck's loader summary less its timing, read_s, and the
  port's parser name, reader=) and exit with their codes.
* dltest's bf16 round-trip error is the JAX cast's bit for bit, for the
  in-line DataLoader, MultiPrefetchLoader and ProcessLoader, and its last
  line is the JAX tool's.
* utils/lowp equals the JAX module bit for bit on random, subnormal,
  overflowing, infinite and NaN inputs.
* gputest's conversion-audit and round-trip lines equal the JAX tool's.
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_fp16_tpu.utils import lowp as jax_lowp
from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
from kaldi_fp16_tpu_torch.tools import (
    csrdump, dltest, egstools, gputest, make_synthetic_egs, nscheck,
)
from kaldi_fp16_tpu_torch.utils import lowp
from tests.test_torch_tool_help import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def egs(tmp_path_factory):
    d = tmp_path_factory.mktemp("egs")
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_egs.main([str(d), "--pdfs", "48", "--den-topology",
                                 "phone-lm"])
    return d


def run(main, argv):
    """(stdout, exit code) of a tool's main."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code or 0
    return buf.getvalue(), code


def jax_tool(name, argv, monkeypatch):
    """(stdout, exit code) of tools/<name>.py's main, in this process."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    return run(lambda _: mod.main(), None)


EGSTOOLS = [
    ("analyze", ["cegs.1.ark", "cegs.2.ark"]),
    ("dump", ["cegs.1.ark", "-n", "3"]),
    ("totext", ["cegs.2.ark"]),
    ("verify", ["cegs.1.ark", "cegs.2.ark"]),
    ("verify", ["cegs.1.ark", "--label-dim", "12"]),
    ("fst", ["den.fst", "-n", "3"]),
    ("compare", ["cegs.1.ark"]),
]


@pytest.mark.parametrize("cmd,args", EGSTOOLS,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(EGSTOOLS)])
def test_egstools_prints_the_jax_tools_stdout(cmd, args, egs, monkeypatch):
    argv = [cmd] + [str(egs / a) if a.endswith((".ark", ".fst")) else a
                    for a in args]
    port = run(egstools.main, argv)
    assert port == jax_tool("egstools", argv, monkeypatch)
    assert port[0]


def loader_summary(line):
    return re.sub(r" (reader|read_s)=\S+", "", line)


def test_nscheck_and_csrdump_print_the_jax_tools_stdout(egs, monkeypatch):
    arks = str(egs / "cegs.*.ark")
    out, code = run(csrdump.main, [arks, "--n", "6"])
    assert (out, code) == jax_tool("csrdump", [arks, "--n", "6"],
                                   monkeypatch)
    assert len(out.splitlines()) == 6
    out, code = run(nscheck.main, [arks, "--batch", "4"])
    jout, jcode = jax_tool("nscheck", [arks, "--batch", "4"], monkeypatch)
    port, jax_lines = out.splitlines(), jout.splitlines()
    assert code == jcode == 0 and port[:-1] == jax_lines[:-1]
    assert loader_summary(port[-1]) == loader_summary(jax_lines[-1])


def jax_bf16_err(batches):
    """tools/dltest.py's cast: max |bf16(x) - x| over the batches."""
    err = 0.0
    for b in batches:
        bf = jnp.asarray(b.features).astype(jnp.bfloat16)
        err = max(err, float(np.abs(np.asarray(bf, np.float32)
                                    - b.features).max()))
    return err


@pytest.mark.parametrize("extra", [[], ["--workers", "2"],
                                   ["--process-workers", "2"]],
                         ids=["dataloader", "threads", "processes"])
def test_dltest_bf16_error_is_the_jax_casts(extra, egs, monkeypatch):
    arks = str(egs / "cegs.*.ark")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dltest.main([arks] + extra)
    batches = list(DataLoader(arks, DataLoaderConfig(batch_size=8)))
    assert res["batches"] == len(batches) == 4
    assert res["bf16_max_err"] == jax_bf16_err(batches)
    jout, _ = jax_tool("dltest", [arks] + extra, monkeypatch)
    assert buf.getvalue().splitlines()[-1] == jout.splitlines()[-1]


def lowp_inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.17e-38, 6e-8,
                        -3e-6, 6.1e-5, 65504.0, 65520.0, -7e4, 1e5, 3.39e38,
                        -3.4e38, np.inf, -np.inf, np.nan], f)
    return {
        "random": (rng.normal(size=4096) * 3).astype(f),
        "wide": (rng.normal(size=4096) * 10.0 ** rng.integers(
            -44, 38, size=4096)).astype(f),
        "subnormal": (rng.uniform(-1, 1, size=1024) * 1e-39).astype(f),
        "special": special,
    }


@pytest.mark.parametrize("name", list(lowp_inputs()))
def test_lowp_equals_the_jax_module(name):
    x = lowp_inputs()[name]
    with np.errstate(over="ignore", invalid="ignore"):
        pairs = [(lowp.f32_to_f16(x), jax_lowp.f32_to_f16(x)),
                 (lowp.f16_to_f32(lowp.f32_to_f16(x)),
                  jax_lowp.f16_to_f32(jax_lowp.f32_to_f16(x))),
                 (lowp.f32_to_bf16(x), jax_lowp.f32_to_bf16(x))]
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            bits = np.uint16 if a.dtype == np.float16 else np.uint32
            assert np.array_equal(a.view(bits), b.view(bits))
        for fmt in ("float16", "bfloat16"):
            assert dataclasses.asdict(lowp.analyze_conversion(x, fmt)) == \
                dataclasses.asdict(jax_lowp.analyze_conversion(x, fmt))
    assert lowp.F16_MAX == jax_lowp.F16_MAX
    assert lowp.BF16_MIN_NORMAL == jax_lowp.BF16_MIN_NORMAL


def test_gputest_audit_lines_equal_the_jax_tools(egs, monkeypatch):
    argv = ["--egs", str(egs / "cegs.*.ark")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = gputest.main(argv + ["--device", "cpu", "--iters", "1",
                                   "--mb", "1"])
    jout, code = jax_tool("gputest", argv + ["--iters", "1", "--mb", "1"],
                          monkeypatch)
    keep = ("float16 round-trip", "bfloat16 round-trip",
            "fp32 device round-trip", "PASS", "parse: 32 examples")

    def audit(text):
        return [ln.split(" in ")[0] if ln.startswith("parse") else ln
                for ln in text.splitlines() if ln.startswith(keep)]

    assert audit(buf.getvalue()) == audit(jout) and code == 0
    assert len(audit(jout)) == 5 and res["bit_exact"]
    assert "pinned" not in res["batch_ms"]
