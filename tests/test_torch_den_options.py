"""The port's den takes every option value the JAX den takes.

Each value that the JAX asserts accept (kaldi_fp16_tpu/chain/
den_structured.py:370, :403; chain/denominator.py:130-132) builds both
packages' dens on the CPU; the port's reports its route (the table in
kaldi_fp16_tpu_torch/chain/den_structured.py) and its log-probs and
posteriors equal those of the den built with the route's own name, bit
for bit.  The JAX package's `KALDI_TPU_DEN_MATMUL` and
`KALDI_TPU_DEN_SCAN` are not read: the arguments alone choose the
route.  Unknown names raise ValueError.  Also the other JAX callers' names:
`CheckpointManager.close`.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import (
    DenominatorComputation as JaxDen,
)
from kaldi_fp16_tpu_torch.chain import den_structured
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import (
    DenominatorComputation, resolve_posterior_reduce,
)
from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager

PHONE_LM = (24, 13, 2, 4)           # pdfs, phones, states per phone, branching


def graphs(kind):
    """(JAX graph, port graph): a phone-LM graph (structured) or a random
    ergodic one (blocked)."""
    if kind == "phone-lm":
        fst, P = jax_graph.make_phone_lm_den_fst(*PHONE_LM, seed=3), 24
    else:
        fst, P = jax_graph.make_simple_den_fst(num_pdfs=6, num_states=5,
                                               seed=3), 6
    return (jax_graph.DenominatorGraph.from_fst(fst, P),
            port_graph.DenominatorGraph.from_fst(fst, P))


def route_of(den, option):
    if option == "posterior_reduce":
        return den.posterior_reduce
    return getattr(den._structured, option)


def run(den, P, seed=1):
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 5, P)).astype(np.float32))
    return den.forward_backward(x)


# (option, the JAX den's value, the port's route on the CPU, graph kind)
JAX_VALUES = [
    ("matmul_impl", "auto", "kernel", "phone-lm"),
    ("matmul_impl", "pallas", "kernel", "phone-lm"),
    ("matmul_impl", "high", "plain", "phone-lm"),
    ("matmul_impl", "split3", "split3", "phone-lm"),
    ("scan_impl", "auto", "loop", "phone-lm"),
    ("scan_impl", "fused", "fused", "phone-lm"),
    ("scan_impl", "xla", "loop", "phone-lm"),
    ("posterior_reduce", "einsum", "einsum", "simple"),
    ("posterior_reduce", "pallas", "kernel", "simple"),
]


@pytest.mark.parametrize("option,value,want,kind", JAX_VALUES)
def test_each_jax_value_takes_its_route(option, value, want, kind):
    jg, pg = graphs(kind)
    JaxDen(jg, **{option: value})            # the JAX den takes it
    den = DenominatorComputation(pg, device="cpu", **{option: value})
    assert route_of(den, option) == want
    ref = DenominatorComputation(pg, device="cpu", **{option: want})
    assert route_of(ref, option) == want
    (lp, post), (lp_r, post_r) = run(den, pg.num_pdfs), run(ref, pg.num_pdfs)
    assert torch.equal(lp, lp_r) and torch.equal(post, post_r)


def test_the_tables_cover_the_jax_values_and_the_ports():
    """Each table maps the JAX names and the port's own names; the port's
    names map to themselves."""
    tables = {"matmul_impl": den_structured.MATMUL_IMPLS,
              "scan_impl": den_structured.SCAN_IMPLS,
              "posterior_reduce": den_structured.POSTERIOR_REDUCES}
    for option, value, want, _ in JAX_VALUES:
        assert value in tables[option]
    assert set(den_structured.MATMUL_IMPLS) == {
        "auto", "kernel", "plain", "split3", "pallas", "high"}
    assert set(den_structured.SCAN_IMPLS) == {"auto", "fused", "loop", "xla"}
    assert set(den_structured.POSTERIOR_REDUCES) == {
        "auto", "einsum", "kernel", "pallas"}
    for table in tables.values():
        for name, route in table.items():
            assert table[route] == route, name


@pytest.mark.parametrize("device,matmul,scan,reduce", [
    ("cpu", "kernel", "loop", "einsum"),
    ("cuda", "kernel", "fused", "kernel"),
])
def test_defaults_resolve_as_before(device, matmul, scan, reduce):
    """The routes are those of the earlier defaults: the kernel, the fused scans and the reduce kernel on a
    card; the loop and the einsum on the CPU."""
    dev = torch.device(device)
    assert den_structured.resolve_matmul_impl("auto") == matmul
    assert den_structured.resolve_scan_impl("auto", dev) == scan
    assert resolve_posterior_reduce("auto", dev) == reduce


@pytest.mark.parametrize("variable,value", [
    ("KALDI_TPU_DEN_MATMUL", "split3"), ("KALDI_TPU_DEN_MATMUL", "high"),
    ("KALDI_TPU_DEN_MATMUL", "pallas"), ("KALDI_TPU_DEN_MATMUL", "tf32"),
    ("KALDI_TPU_DEN_SCAN", "fused"), ("KALDI_TPU_DEN_SCAN", "xla"),
    ("KALDI_TPU_DEN_SCAN", "tf32"),
])
def test_environment_leaves_the_routes_alone(monkeypatch, variable, value):
    """The JAX package's re-audit variables, set to a name or to none,
    neither move "auto" off the default route nor raise."""
    _, pg = graphs("phone-lm")
    monkeypatch.setenv(variable, value)
    for kw in ({}, dict(matmul_impl="auto", scan_impl="auto")):
        den = DenominatorComputation(pg, device="cpu", **kw)
        assert route_of(den, "matmul_impl") == "kernel"
        assert route_of(den, "scan_impl") == "loop"
    assert den_structured.resolve_scan_impl(
        "auto", torch.device("cuda")) == "fused"


@pytest.mark.parametrize("option,value", [
    ("matmul_impl", "tf32"), ("matmul_impl", "fast"),
    ("scan_impl", "scan"), ("scan_impl", "pallas"),
    ("posterior_reduce", "segment"), ("posterior_reduce", "xla"),
    ("mode", "bf16"), ("layout", "dense"),
])
def test_unknown_names_raise(option, value):
    for kind in ("phone-lm", "simple"):
        with pytest.raises(ValueError, match=option):
            DenominatorComputation(graphs(kind)[1], device="cpu",
                                   **{option: value})


def test_checkpoint_manager_close_is_callable_twice(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.close()
    mgr.close()
    assert mgr.all_steps() == []
