"""The port's tools.chainverify against tools/chainverify.py on the CPU.

* Line for line at the defaults and at --topology phone-lm: the same
  checks in the same order, every fp64 oracle value equal (both print it
  to 6 decimals from the same test point), and every "got" value within
  the strict 2e-6 of the JAX tool's (which prints it to 6 decimals, so
  + 5e-7 of rounding).
* A den with a wrong leaky coefficient makes the tool exit 1: the control
  that it can fail.
* The den route it reports: "loop" at N = 2 and, on the CPU (no fused
  scans by default), at N = 128 too.
* Phase 3 differences the probed row's objective where the JAX tool
  differences the batch total: at the JAX tool's sizes the two finite
  differences agree point for point within the batch total's fp32 noise
  (~ulp(|total|) / eps), and the analytic derivatives agree.
"""

import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import (
    DenominatorComputation as JaxDen,
)
from kaldi_fp16_tpu.chain.objective import (
    ChainTrainingOpts as JaxOpts, chain_objf_and_deriv,
)
from kaldi_fp16_tpu.io import fst as jax_fst
from kaldi_fp16_tpu.io.sparse import fst_to_csr as jax_fst_to_csr
from kaldi_fp16_tpu_torch.chain import denominator as port_denominator
from kaldi_fp16_tpu_torch.tools import chainverify
from tests.test_torch_tool_help import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STRICT = 2e-6
CHECK = re.compile(r"^\s+(OK |FAIL) (\S+): got (-?[\d.]+) ref (-?[\d.]+)")


def checks(text):
    """[(status, name, got, ref string)] of the printed check lines."""
    out = []
    for line in text.splitlines():
        m = CHECK.match(line)
        if m:
            out.append((m.group(1).strip(), m.group(2), float(m.group(3)),
                        m.group(4)))
    return out


def run_jax(*args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "chainverify.py"),
         "--platform", "cpu", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "KALDI_TPU_NO_COMPILE_CACHE": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("extra", [[], ["--topology", "phone-lm"]],
                         ids=["defaults", "phone-lm"])
def test_lines_match_the_jax_tool(extra, capsys):
    res = chainverify.main(["--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert res["failures"] == 0 and out.strip().endswith("PASS")
    jax_lines = checks(run_jax(*extra))
    port_lines = checks(out)
    assert [c[:2] for c in port_lines] == [c[:2] for c in jax_lines]
    assert all(c[0] == "OK" for c in port_lines)
    port_vals = [(n, got, ref) for p in ("strict", "device")
                 for n, got, ref in res["passes"][p]["checks"]]
    assert len(port_vals) == len(jax_lines)
    for (name, got, ref), (_, jname, jgot, jref) in zip(port_vals,
                                                       jax_lines):
        assert f"{ref:.6f}" == jref, (name, ref, jref)
        assert abs(got - jgot) <= STRICT + 5e-7, (name, got, jgot)


def test_a_wrong_leaky_den_fails(monkeypatch, capsys):
    real = port_denominator.DenominatorComputation

    def leaky_den(graph, leaky=1e-5, **kw):
        return real(graph, leaky=1e-2, **kw)

    monkeypatch.setattr(port_denominator, "DenominatorComputation",
                        leaky_den)
    monkeypatch.setattr(sys, "argv", ["chainverify", "--device", "cpu",
                                      "--topology", "phone-lm"])
    # run the module afresh as __main__ (its den name bound to the patch)
    monkeypatch.delitem(sys.modules,
                        "kaldi_fp16_tpu_torch.tools.chainverify")
    with pytest.raises(SystemExit) as e:
        runpy.run_module("kaldi_fp16_tpu_torch.tools.chainverify",
                         run_name="__main__")
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and out.strip().splitlines()[-1].startswith("FAIL")


@pytest.mark.parametrize("batch", [2, 128])
def test_route_is_the_loop_scans_on_the_cpu(batch, capsys):
    res = chainverify.main(["--device", "cpu", "--topology", "phone-lm",
                            "--batch", str(batch), "--skip-strict"])
    assert res["failures"] == 0
    assert res["route"] == {"layout": "structured", "scan": "loop",
                            "posterior_reduce": None}
    assert (f"den route: layout=structured scan=loop posterior_reduce=None "
            f"(N = {batch})") in capsys.readouterr().out


def jax_total_fd(topology):
    """tools/chainverify.py's phase 3 at its defaults, on the JAX package:
    [(b, t, p, fd of the batch total, analytic deriv)]."""
    rng = np.random.default_rng(0)
    P, T, B = 24, 8, 2
    if topology == "phone-lm":
        g = jax_graph.DenominatorGraph.from_fst(
            jax_graph.make_phone_lm_den_fst(num_pdfs=P, num_phones=6,
                                            states_per_phone=2, branching=3,
                                            seed=1), P)
    else:
        g = jax_graph.DenominatorGraph.from_fst(
            jax_graph.make_simple_den_fst(num_pdfs=P, num_states=8, seed=1),
            P)

    def linear_fst():
        states = [jax_fst.FstState() for _ in range(T + 1)]
        for t in range(T):
            states[t].arcs.append(
                jax_fst.FstArc(int(rng.integers(1, P + 1)), 0.3, t + 1))
            states[t].arcs.append(
                jax_fst.FstArc(int(rng.integers(1, P + 1)), 1.0, t + 1))
        states[-1].final = 0.0
        return jax_fst.Fst(start=0, states=states)

    num = jax_graph.build_numerator_batch(
        [jax_fst_to_csr(linear_fst()) for _ in range(B)])
    out = (rng.normal(size=(B, T, P)) * 0.5).astype(np.float32)
    points = [(int(rng.integers(B)), int(rng.integers(T)),
               int(rng.integers(P))) for _ in range(8)]
    den = JaxDen(g, leaky=1e-5)
    opts = JaxOpts(out_of_range_regularize=0.0)
    _, deriv = chain_objf_and_deriv(num, den, jnp.asarray(out), opts=opts)
    deriv = np.asarray(deriv)
    eps = 1e-3
    rows = []
    for b, t, p in points:
        o1, o2 = out.copy(), out.copy()
        o1[b, t, p] -= eps
        o2[b, t, p] += eps
        r1, _ = chain_objf_and_deriv(num, den, jnp.asarray(o1), opts=opts)
        r2, _ = chain_objf_and_deriv(num, den, jnp.asarray(o2), opts=opts)
        rows.append((b, t, p, (float(r2.total_objf) - float(r1.total_objf))
                     / (2 * eps), float(deriv[b, t, p]), abs(float(
                         r1.total_objf))))
    return rows


@pytest.mark.parametrize("topology", ["random", "phone-lm"])
def test_phase3_row_route_agrees_with_the_jax_total_route(topology,
                                                          capsys):
    res = chainverify.main(["--device", "cpu", "--topology", topology,
                            "--skip-strict"])
    capsys.readouterr()
    port = res["passes"]["device"]["fd"]
    jax_rows = jax_total_fd(topology)
    assert [r[:3] for r in port] == [r[:3] for r in jax_rows]
    for (_, _, _, fd, ana), (_, _, _, jfd, jana, total) in zip(port,
                                                              jax_rows):
        assert abs(ana - jana) <= 1e-5
        # the JAX difference carries ~ulp(|total|) / eps of fp32 noise per
        # evaluation, two evaluations
        noise = 2 * np.spacing(np.float32(total)) / 1e-3
        assert abs(fd - jfd) <= noise + 1e-4, (fd, jfd, noise)
    assert res["passes"]["device"]["fd_err"] <= 2e-3
