"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
of a tiny cell on the CPU (the program in float32, the limits tight), with
one fault planted in the port: a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; the learning
rate doubled; the momentum ignored (the step cell's).  The controls come
out not correct too: the reference at the next precision down (float8
operands) put in the program's place, judged by the network's numbers,
and the program's own bf16 den (mode "fast") put in the exact den's place
on the program's output, judged by the chain's; a sound run, correct."""

import dataclasses

import pytest
import torch

from test_bench_reference import fp32_root, run
import tiny
from benchmark.harness import training as tr

TIGHT = {n: 1e-4 for n in tr.NUMBERS}
CELLS = {"tiny.recipe": dict(tiny.RECIPE, limits=TIGHT),
         "tiny.step": dict(tiny.STEP, limits=TIGHT)}


@pytest.fixture
def root(tmp_path):
    return fp32_root(tmp_path, CELLS)


def _unchanged(monkeypatch):
    from kaldi_fp16_tpu_torch.training import train_step

    def sgd_update(params, grads, opt_state, *a, **k):
        stats = {"param_change_norm": torch.zeros(()),
                 "global_clip_scale": torch.ones(())}
        return ({l: {n: w.detach().clone() for n, w in p.items()}
                 for l, p in params.items()},
                {"velocity": opt_state["velocity"],
                 "step": opt_state["step"] + 1}, stats)
    monkeypatch.setattr(train_step, "sgd_update", sgd_update)


def _half_batch(monkeypatch):
    from kaldi_fp16_tpu_torch.training import train_step, trainer
    make = train_step.make_train_step

    def make_half(*a, **k):
        step = make(*a, **k)

        def half(opt, scale, batch, *sa, num_graph=None, **sk):
            h = batch["features"].shape[0] // 2
            batch = {n: v[:h] for n, v in batch.items()}
            batch["weights"] = batch["weights"] * 2.0
            if num_graph is not None:
                num_graph = dataclasses.replace(num_graph, **{
                    f.name: getattr(num_graph, f.name)[:h]
                    for f in dataclasses.fields(num_graph)
                    if f.name not in ("num_states", "num_arcs")})
            return step(opt, scale, batch, *sa, num_graph=num_graph, **sk)
        return half
    monkeypatch.setattr(train_step, "make_train_step", make_half)
    monkeypatch.setattr(trainer, "make_train_step", make_half)


def _sgd_config(monkeypatch, **change):
    from kaldi_fp16_tpu_torch.training import train_step
    update = train_step.sgd_update

    def sgd_update(params, grads, opt_state, config, *a, lr=None, **k):
        new = {n: f(getattr(config, n)) for n, f in change.items()}
        if lr is not None and "learning_rate" in change:
            lr = change["learning_rate"](lr)
        return update(params, grads, opt_state,
                      dataclasses.replace(config, **new), *a, lr=lr, **k)
    monkeypatch.setattr(train_step, "sgd_update", sgd_update)


def _lr_doubled(monkeypatch):
    _sgd_config(monkeypatch, learning_rate=lambda v: 2.0 * v)


def _momentum_ignored(monkeypatch):
    _sgd_config(monkeypatch, momentum=lambda v: 0.0)


FAULTS = [(c, f) for c in sorted(CELLS)
          for f in (_unchanged, _half_batch, _lr_doubled)] + [
    ("tiny.step", _momentum_ignored)]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, two_threads, cell):
    assert run(root, cell)["correct"]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(root, two_threads, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(root, tmp_path, two_threads, cell):
    """The control (benchmark/calibrate.py's): the reference with float8
    operands put in the program's place, judged by the cell's limits."""
    from benchmark.harness import core, training as tr
    cpu = torch.device("cpu")
    spec = core.cell_spec(cell, root)
    driver = core.load_module(root / "benchmark" / "drivers"
                              / f"{spec['cell']['driver']}.py", "driver")
    r = driver.Run(driver.prepare(spec, cpu), spec, 2**40 + 3, cpu,
                   str(tmp_path))
    r.first_steps()
    weights, batches, lrs, mask_seed = r.reference_inputs()
    r.close()
    ref = tr.reference_readings(spec, weights, batches, lrs, mask_seed, cpu)
    ctl = tr.reference_readings(spec, weights, batches, lrs, mask_seed, cpu,
                                control=True)
    limits = {n: spec["cell"]["limits"][n] for n in tr.NET_NUMBERS}
    checks, correct, _ = tr.compare(ctl, ref, limits)
    assert not correct, checks


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_chain_control_is_not_correct(root, tmp_path, two_threads, cell):
    """The chain's control (benchmark/calibrate.py's): the program's bf16
    den (mode "fast") and the reference numerator in bf16, on the
    program's own step-1 output, judged by the chain's limits; the exact
    den on that output reads within them."""
    from benchmark.harness import core
    cpu = torch.device("cpu")
    spec = core.cell_spec(cell, root)
    driver = core.load_module(root / "benchmark" / "drivers"
                              / f"{spec['cell']['driver']}.py", "driver")
    r = driver.Run(driver.prepare(spec, cpu), spec, 2**40 + 5, cpu,
                   str(tmp_path))
    prog = r.first_steps()
    batches = r.reference_inputs()[1]
    r.close()
    limits = {n: spec["cell"]["limits"][n] for n in tr.CHAIN_NUMBERS}
    sound = tr.chain_gaps(prog["chain"], tr.chain_reference(
        spec, prog["chain"]["x"], batches[0], cpu))
    assert all(sound[n] <= limits[n] for n in limits), sound
    ctl = tr.chain_control(spec, prog["chain"]["x"], batches[0], cpu)
    gaps = tr.chain_gaps(ctl, tr.chain_reference(
        spec, prog["chain"]["x"], batches[0], cpu))
    assert not all(gaps[n] <= limits[n] for n in limits), gaps
