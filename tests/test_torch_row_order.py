"""How far the flagship's first update moves when the batch's rows are
permuted: the same mathematics summed in another order, the yardstick
that chip_smoke.py's two-rank comparison at flagship width is held to.

configs/cnn_tdnn.xconfig at full width with SpecAugment off, B = 32,
T_in = 24, fp32, from the JAX package's initial state: one step on the
batch in order and one on its halves swapped.  At this init the step is
ill-conditioned in both frameworks: last-bit changes in the BatchNorm
statistics move the update by about 0.2-0.6 %, far above fp32 rounding.
The port must be no more sensitive than the JAX step (within a factor of
ROW_ORDER_RATIO), and the first loss must agree across the frameworks
at the cross-framework bar of tests/test_torch_train_step.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kaldi_fp16_tpu.chain import graph as jax_graph
from kaldi_fp16_tpu.chain.denominator import DenominatorComputation as JaxDen
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts as JaxOpts
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.training import train_step as jax_ts
from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.tools.profile_step import supervision
from kaldi_fp16_tpu_torch.training import train_step as port_ts
from tests.test_torch_train_step import SCALAR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_IN, P = 32, 24, 3080
T_OUT = (T_IN - 3 + 2) // 3
MIN_DISTANCE = 1e-3          # the JAX step's own distance, well above rounding
ROW_ORDER_RATIO = 10.0
CONFIG = dict(learning_rate=1e-3, momentum=0.9, frame_subsampling_factor=3,
              left_context=3, compute_dtype="float32")


def flagship_xconfig():
    with open(os.path.join(ROOT, "configs", "cnn_tdnn.xconfig")) as f:
        return f.read().replace(
            "freq-max-proportion=0.5 time-zeroed-proportion=0.2",
            "freq-max-proportion=0.0 time-zeroed-proportion=0.0")


def permuted(g, perm, cls):
    return cls(**{f.name: (getattr(g, f.name)[perm]
                           if isinstance(getattr(g, f.name), np.ndarray)
                           else getattr(g, f.name))
                  for f in dataclasses.fields(cls)})


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v, np.float64)})
    return out


def update_distance(a, b, init):
    """||u_a - u_b|| / ||u_b|| over every parameter's update."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float(((b[k] - init[k]) ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def leaf_distance(a, b, init, k):
    return float(np.linalg.norm(a[k] - b[k])
                 / np.linalg.norm(b[k] - np.asarray(init[k], np.float64)))


def test_flagship_step_row_order_sensitivity_matches_jax():
    xconfig = flagship_xconfig()
    rng = np.random.default_rng(0)
    graph = supervision(B, T_OUT, 64, P, rng)
    feats = rng.normal(size=(B, T_IN, 40)).astype(np.float32)
    ivecs = rng.normal(size=(B, 100)).astype(np.float32)
    ident, swap = np.arange(B), np.r_[B // 2:B, 0:B // 2]

    jm = jax_build_from_string(xconfig)
    jden = JaxDen(jax_graph.DenominatorGraph.from_fst(
        jax_graph.make_simple_den_fst(num_pdfs=P, num_states=40, seed=1), P),
        leaky=1e-5)
    jcfg = jax_ts.TrainConfig(**CONFIG)
    init = list(jax_ts.init_train_state(jm, jax.random.PRNGKey(0), jcfg))
    init_np = [jax.tree_util.tree_map(np.asarray, t) for t in init[:2]]

    def jax_step(perm):
        step = jax_ts.make_train_step(
            jm, jden, permuted(graph, perm, jax_graph.NumeratorGraphBatch),
            JaxOpts(), jcfg, num_frames_out=T_OUT, donate=False)
        batch = {"features": jnp.asarray(feats[perm]),
                 "ivectors": jnp.asarray(ivecs[perm]),
                 "weights": jnp.ones(B)}
        *state, out = step(*init, batch, jax.random.PRNGKey(1))
        return flat(jax.tree_util.tree_map(np.asarray, state[0])), \
            float(out.loss)

    pm = build_model_from_string(xconfig)
    pden = DenominatorComputation(port_graph.DenominatorGraph.from_fst(
        port_graph.make_simple_den_fst(num_pdfs=P, num_states=40, seed=1),
        P), leaky=1e-5, device="cpu")
    start = params_from_jax(pm, *init_np)

    def port_step(perm):
        config = port_ts.TrainConfig(**CONFIG)
        net, opt, scale = port_ts.init_train_state(
            pm, torch.Generator().manual_seed(0), config, "cpu")
        net.load_state_dict(start, strict=True)
        step = port_ts.make_train_step(
            pm, net, pden, permuted(graph, perm,
                                    port_graph.NumeratorGraphBatch),
            ChainTrainingOpts(), config, num_frames_out=T_OUT)
        batch = {"features": torch.from_numpy(feats[perm]),
                 "ivectors": torch.from_numpy(ivecs[perm]),
                 "weights": torch.ones(B)}
        opt, scale, out = step(opt, scale, batch)
        return {k: v.detach().double().numpy()
                for k, v in net.state_dict().items()
                if not k.endswith((".count", ".mean", ".var"))}, \
            float(out.loss)

    (ja, jloss), (jb, _) = jax_step(ident), jax_step(swap)
    (pa, ploss), (pb, _) = port_step(ident), port_step(swap)
    d_jax = update_distance(jb, ja, flat(init_np[0]))
    d_port = update_distance(pb, pa, {k: v.double().numpy()
                                      for k, v in start.items()})
    print(f"row-order update distance: JAX {d_jax:.3e}, port {d_port:.3e}")
    for leaf in ("output/w", "prefinal-chain/small_w", "prefinal-chain/big_w"):
        d_leaf = (leaf_distance(jb, ja, flat(init_np[0]), leaf),
                  leaf_distance(pb, pa, start,
                                "layers." + leaf.replace("/", ".")))
        print(f"  {leaf}: JAX {d_leaf[0]:.2e}, port {d_leaf[1]:.2e}")
    np.testing.assert_allclose(ploss, jloss, **SCALAR)
    assert d_jax > MIN_DISTANCE
    assert d_port <= ROW_ORDER_RATIO * d_jax
    assert d_port >= d_jax / ROW_ORDER_RATIO
