"""`TrainConfig.remat` (torch.utils.checkpoint over the network forward)
changes memory, never the numbers: a remat step against the same step
without it, at the JAX package's bars (tests/test_training.py:407-428:
loss rel 1e-6, grad_norm rel 1e-5, parameters rtol 1e-5 / atol 1e-7), on
the CPU:

* plain, and the JAX remat step from the same state at the port's
  cross-framework bars (tests/test_torch_train_step.py);
* with SpecAugment: the masks are drawn before the checkpointed region,
  so the generator ends in the state a plain step leaves it in (a
  resumed run depends on it);
* with NG-SGD (ranks 4): the recompute neither records a site again nor
  hooks a second output, so the NG statistics equal a plain step's;
* BatchNorm's running statistics are those of the first forward (the
  recompute's are discarded);
* on two gloo ranks (tests/test_torch_parallel.py's setup), where the
  recompute repeats BatchNorm's all-reduces on every rank.

Each remat step runs the forward twice (the recompute), counted.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.convert import params_to_numpy
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import run_on_ranks
from kaldi_fp16_tpu_torch.training.loss_scale import init_loss_scale
from kaldi_fp16_tpu_torch.training.optimizer import init_sgd_state
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from tests.test_chain_numerator import random_fst
from tests import test_torch_parallel as tp
from tests import test_torch_train_step as ts

LOSS = dict(rel=1e-6)
GRAD_NORM = dict(rel=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-7)
SPEC_XCONFIG = ts.XCONFIG.replace(
    "batchnorm-component name=idct-batchnorm input=idct",
    "batchnorm-component name=idct-batchnorm input=idct\n"
    "spec-augment-layer name=spec-augment freq-max-proportion=0.5 "
    "time-zeroed-proportion=0.2 time-mask-max-frames=4")
NG = dict(natural_gradient=True, ng_rank_in=4, ng_rank_out=4)


def run_steps(remat, xconfig=ts.XCONFIG, steps=2, spec_seed=None, **cfg):
    """`steps` fp32 steps of the narrow flagship from seed 0; returns the
    outputs, state_dict, opt_state, the generator's state and the
    forward's calls."""
    rng = np.random.default_rng(3)
    csrs = [fst_to_csr(random_fst(rng, num_states=2 * (ts.T_OUT + 1),
                                  num_pdfs=ts.P, T=ts.T_OUT))
            for _ in range(ts.B)]
    batch = {"features": torch.from_numpy(
                 rng.normal(size=(ts.B, ts.T_IN, 8)).astype(np.float32)),
             "ivectors": torch.from_numpy(
                 rng.normal(size=(ts.B, 10)).astype(np.float32))}
    model = build_model_from_string(xconfig)
    den = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_phone_lm_den_fst(**ts.DEN_KW), ts.P), leaky=1e-5,
        device="cpu")
    config = TrainConfig(learning_rate=0.02, momentum=0.5,
                         frame_subsampling_factor=ts.STRIDE,
                         left_context=ts.LEFT, compute_dtype="float32",
                         remat=remat, **cfg)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, device="cpu")
    calls = [0]
    forward = net.forward

    def counted(*args, **kwargs):
        calls[0] += 1
        return forward(*args, **kwargs)

    net.forward = counted
    step = make_train_step(model, net, den,
                           port_graph.build_numerator_batch(csrs),
                           ChainTrainingOpts(), config,
                           num_frames_out=ts.T_OUT)
    gen = (None if spec_seed is None
           else torch.Generator().manual_seed(spec_seed))
    outs = []
    for _ in range(steps):
        opt, scale, out = step(opt, scale, batch, generator=gen)
        outs.append(out)
    return {"outs": outs, "params": {k: v.clone() for k, v in
                                     net.state_dict().items()},
            "opt": opt, "gen": None if gen is None else gen.get_state(),
            "calls": calls[0]}


def assert_same_numbers(a, b):
    for oa, ob in zip(a["outs"], b["outs"]):
        assert float(oa.loss) == pytest.approx(float(ob.loss), **LOSS)
        assert float(oa.grad_norm) == pytest.approx(float(ob.grad_norm),
                                                    **GRAD_NORM)
    for k, v in a["params"].items():
        np.testing.assert_allclose(b["params"][k].numpy(), v.numpy(),
                                   **PARAMS, err_msg=k)


def test_remat_matches_plain_and_recomputes():
    plain, remat = run_steps(False), run_steps(True)
    assert_same_numbers(plain, remat)
    assert (plain["calls"], remat["calls"]) == (2, 4)


def test_remat_matches_the_jax_remat_step():
    jstep, jstate, pstep, net, np_batch, _ = ts._setup({"remat": True})
    jstate = jstep(*jstate, {k: jax.numpy.asarray(v)
                             for k, v in np_batch.items()},
                   jax.random.PRNGKey(3))
    _, _, out = pstep(init_sgd_state(net.params),
                      init_loss_scale(1.0, device="cpu"),
                      {k: torch.from_numpy(v) for k, v in np_batch.items()})
    jout = jstate[4]
    np.testing.assert_allclose(float(out.loss), float(jout.loss), **ts.SCALAR)
    np.testing.assert_allclose(float(out.grad_norm), float(jout.grad_norm),
                               **ts.SCALAR)
    got = ts._flat(params_to_numpy(net)[0])
    for k, v in ts._flat(jax.tree_util.tree_map(np.asarray,
                                                jstate[0])).items():
        np.testing.assert_allclose(got[k], v, **ts.PARAM, err_msg=k)


def test_remat_with_spec_augment_leaves_the_generator_as_a_plain_step():
    plain = run_steps(False, SPEC_XCONFIG, spec_seed=7)
    remat = run_steps(True, SPEC_XCONFIG, spec_seed=7)
    assert_same_numbers(plain, remat)
    assert torch.equal(plain["gen"], remat["gen"])
    fresh = torch.Generator().manual_seed(7).get_state()
    assert not torch.equal(plain["gen"], fresh)       # masks were drawn


def test_remat_with_ng_gives_a_plain_steps_ng_statistics():
    plain = run_steps(False, steps=2, **NG)
    remat = run_steps(True, steps=2, **NG)
    assert_same_numbers(plain, remat)
    for site, st in plain["opt"]["ng"].items():
        for side in ("in", "out"):
            for name, a in st[side]._asdict().items():
                b = getattr(remat["opt"]["ng"][site][side], name)
                assert torch.equal(a, b), f"{site}/{side}/{name}"
    assert int(plain["opt"]["ng"]["output/w"]["in"].t) == 2


def test_remat_bn_buffers_equal_a_plain_step():
    plain, remat = run_steps(False, steps=1), run_steps(True, steps=1)
    bn = [k for k in plain["params"]
          if k.rsplit(".", 1)[-1] in ("count", "mean", "var")]
    assert bn
    for k in bn:
        assert torch.equal(plain["params"][k], remat["params"][k]), k
    # one step merged the batch once: count = B * frames of that layer
    assert float(plain["params"]["layers.idct-batchnorm.bn.count"]) == \
        ts.B * ts.T_IN


def test_remat_on_two_gloo_ranks_equals_plain_ranks_and_one_process():
    base = tp.make_setup(steps=2)
    remat = dataclasses.replace(base, config=dict(base.config, remat=True))
    res = run_on_ranks([base, remat], 2, join_seconds=tp.JOIN_SECONDS,
                       device="cpu")
    single = tp.run_setup(base, device="cpu")
    for rank in res:
        plain_r, remat_r = rank
        for oa, ob in zip(plain_r["outputs"], remat_r["outputs"]):
            assert ob["loss"] == pytest.approx(oa["loss"], **LOSS)
            assert ob["grad_norm"] == pytest.approx(oa["grad_norm"],
                                                    **GRAD_NORM)
        for k, v in plain_r["params"].items():
            np.testing.assert_allclose(remat_r["params"][k], v, **PARAMS,
                                       err_msg=k)
        tp.assert_like_one_process(remat_r, single)


def test_a_frozen_ng_context_records_nothing():
    """The recompute's sites: no new X, no second hook."""
    from kaldi_fp16_tpu_torch.models.network import NGContext
    ng = NGContext()
    x = torch.ones(2, 3)
    out = (x * 2).requires_grad_()
    ng.site("s", x, out)
    ng.frozen = True
    again = (x * 3).requires_grad_()
    assert ng.site("s", x + 1, again) is again
    assert torch.equal(ng.xs["s"], x)
    again.sum().backward()
    assert "s" not in ng.gs
    out.sum().backward()
    assert torch.equal(ng.gs["s"], torch.ones(2, 3))
