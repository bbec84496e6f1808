"""Kaldi's TDNN-LSTM on the port: the xconfig layers, the fast-lstmp
recurrence (ops/lstmp.py) and the frame grid under an output-delay.

CPU tests hold the port's plain path against the benchmark's plain float32
reference (benchmark/reference/tdnn_lstm.py, written from Kaldi's
equations): one fast-lstmp layer's outputs, input derivative and
gradients, and a tiny TDNN-LSTM network on the grid.  The two compute in
float32 with the same operations in another order, so they agree to
float32 rounding (1e-5 relative, with room for the ~100 steps of
recurrence the errors pass through).

The `gpu` tests hold the CUDA kernel (csrc/lstmp.cu) against the plain
loop on the card, forward and backward, at the benchmark cell's shape and
at a ragged one, one launch a pass:
`python -m pytest --noconftest -m gpu tests/test_torch_lstmp.py`.
"""

import math

import pytest
import torch

from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.xconfig import LayerType, parse_xconfig
from kaldi_fp16_tpu_torch.ops.lstmp import (
    LstmpSteps, lstmp_recurrence, lstmp_recurrence_plain,
)

# the recipe's own lines (run_tdnn_lstm_1e.sh's network.xconfig, with its
# shell variables filled in)
RECIPE = """\
input dim=100 name=ivector
input dim=40 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0)) affine-transform-file=exp/chain/tdnn_lstm_1e_sp/configs/lda.mat
relu-renorm-layer name=tdnn1 dim=1024
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=1024
fast-lstmp-layer name=fastlstm1 cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256 delay=-3 decay-time=20
relu-renorm-layer name=tdnn4 input=Append(-3,0,3) dim=1024
output-layer name=output input=fastlstm1 output-delay=5 include-log-softmax=false dim=3080 max-change=1.5
output-layer name=output-xent input=fastlstm1 output-delay=5 dim=3080 learning-rate-factor=5.0 max-change=1.5
"""


def test_recipe_lines_parse():
    cfgs = parse_xconfig(RECIPE)
    types = [c.type for c in cfgs]
    assert types[2:6] == [LayerType.FIXED_AFFINE, LayerType.RELU_RENORM,
                          LayerType.RELU_RENORM, LayerType.FAST_LSTMP]
    model = build_model_from_string(RECIPE)
    lda = model.layer_map["lda"]
    assert lda.input.names == ["input"] * 5 + ["ivector"]
    assert lda.input.offsets == [-2, -1, 0, 1, 2, 0]
    assert lda.input_dim == 300 and lda.output_dim == 300
    assert lda.spec.affine_file.endswith("lda.mat")
    assert model.layer_map["tdnn2"].input.offsets == [-1, 0, 1]
    assert model.layer_map["tdnn2"].input_dim == 3072
    lstm = model.layer_map["fastlstm1"].spec
    assert (lstm.cell_dim, lstm.recurrent_dim, lstm.nonrecurrent_dim,
            lstm.delay) == (1024, 256, 256, -3)
    assert math.isclose(lstm.scale, 0.85)
    assert (lstm.clipping_threshold, lstm.zeroing_threshold,
            lstm.zeroing_interval) == (30.0, 15.0, 20)
    assert model.layer_map["fastlstm1"].output_dim == 512
    assert model.layer_map["tdnn4"].input_dim == 1536
    out = model.layer_map["output"].spec
    assert out.output_delay == 5 and not out.include_log_softmax
    assert model.layer_map["output-xent"].spec.learning_rate_factor == 5.0


def test_fast_lstmp_defaults():
    model = build_model_from_string(
        "input dim=8 name=input\n"
        "fast-lstmp-layer name=l cell-dim=16\n"
        "output-layer name=output dim=4\n")
    s = model.layer_map["l"].spec
    assert (s.recurrent_dim, s.nonrecurrent_dim, s.delay) == (4, 4, -1)
    assert s.scale == 1.0 and s.decay_time < 0
    assert model.layer_map["output"].spec.output_delay == 0


def test_benchmark_model_context_and_size():
    from pathlib import Path
    from kaldi_fp16_tpu_torch.models.model import build_model
    root = Path(__file__).resolve().parents[1]
    model = build_model(str(root / "benchmark" / "configs"
                            / "tdnn_lstm.xconfig"))
    assert model.time_context() == (21, 11)
    assert 36e6 < model.num_params() < 37e6


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the recurrence kernel is CUDA only")
    return torch.device("cuda")


def _inputs(B, T, C, R, dev, seed, grad_scale):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale)
    z = rnd(B, T, 4 * C)
    w_r = rnd(R, 4 * C, scale=R ** -0.5)
    peep = rnd(3, C, scale=0.3)
    w_rr = rnd(C, R, scale=C ** -0.5)
    b_r = rnd(R, scale=0.1)
    g_r = rnd(B, T, R, scale=grad_scale)
    g_m = rnd(B, T, C, scale=grad_scale)
    return [z, w_r, peep, w_rr, b_r], g_r, g_m


def _run(fn, leaves, g_r, g_m, steps):
    xs = [x.clone().requires_grad_(True) for x in leaves]
    r, m = fn(*xs, steps)
    torch.autograd.backward([r, m], [g_r, g_m])
    return [r.detach(), m.detach()] + [x.grad for x in xs]


# B, T, C, R, start, delay, window, grad scale: the benchmark cell's layer
# (64 sequences, 72 grid steps, the recurrence from step 1, the derivative
# window from step 10, derivatives large enough to clip and zero), and a
# ragged one with full-rate delay 3
CARD_CASES = {
    "cell": (64, 72, 1024, 256, 1, 1, (10, 71), 3.0),
    "ragged": (3, 7, 40, 12, 1, 3, (2, 5), 30.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_kernel_against_plain(case, bf16):
    """The kernel against the plain loop on the card, repeats
    bit-identical, one launch a pass.  With float32 operands the two differ
    by the order of float32 sums alone (~5e-7 of the norms through 71
    steps; bars 2e-5 and 1e-4).  With bf16 operands such a difference now
    and then moves r' or m across a bf16 rounding boundary (one ulp, 2^-8
    relative), and the recurrence carries that on: ~1e-3 of the norms at
    the cell's shape, so the bars are 5e-3 there."""
    dev = _card()
    B, T, C, R, start, delay, (lo, hi), gs = CARD_CASES[case]
    leaves, g_r, g_m = _inputs(B, T, C, R, dev, 7, gs)
    steps = LstmpSteps(start=start, delay=delay, scale=0.85, deriv_lo=lo,
                       deriv_hi=hi, recurrence_frames=3, frame0=-40,
                       frame_step=3 if delay == 1 else 1, bf16_ops=bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = _run(lstmp_recurrence_plain, leaves, g_r, g_m, steps)
    before = lstmp_recurrence.launches
    kern = _run(lstmp_recurrence, leaves, g_r, g_m, steps)
    torch.cuda.synchronize()
    assert lstmp_recurrence.launches - before == 2
    again = _run(lstmp_recurrence, leaves, g_r, g_m, steps)
    names = ["r", "m", "dz", "dw_r", "dpeep", "dw_rr", "db_r"]
    gaps = {n: float((k - p).norm() / p.norm().clamp(min=1e-30))
            for n, k, p in zip(names, kern, plain)}
    bars = ({n: 5e-3 for n in names} if bf16
            else dict({n: 1e-4 for n in names}, r=2e-5, m=2e-5))
    assert all(v < bars[n] for n, v in gaps.items()), gaps
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    assert kern[2][:, :lo].abs().sum() == 0
    assert kern[2][:, hi + 1:].abs().sum() == 0


# ---------------------------------------------------------------------------
# The plain path against the benchmark's reference (CPU, float32)
# ---------------------------------------------------------------------------

from benchmark.reference import tdnn_lstm as ref  # noqa: E402
from kaldi_fp16_tpu_torch.models.network import (  # noqa: E402
    ChunkTimes, Network, _fwd_fast_lstmp, grid_delay, grid_layers,
    ng_sites,
)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _layer_xconfig(decay):
    return ("input dim=12 name=input\n"
            "fast-lstmp-layer name=l cell-dim=32 recurrent-projection-dim=8 "
            f"non-recurrent-projection-dim=6 delay=-3 decay-time={decay}\n"
            "output-layer name=output dim=5\n")


# decay-time, upstream derivative scale, derivative window (None: none):
# s = 1 and s = 0.85 at derivatives under the thresholds, derivatives that
# clip every row (195 of 195 rows clipped, 28 zeroed), ones that cross the
# zeroing threshold but not the clip (13 rows zeroed, none clipped), and
# the margin cutting the left context
LAYER_CASES = {
    "s1": (-1, 0.05, None),
    "decay": (20, 0.05, None),
    "clip": (20, 200.0, None),
    "zeroing": (20, 10.0, None),
    "margin": (20, 0.05, (9, 40)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_against_reference(case):
    """One fast-lstmp layer at the full frame rate (delay 3 frames): the
    port's plain path (network._fwd_fast_lstmp, ops.lstmp's loop) against
    the reference, outputs, input derivative and every gradient."""
    decay, gscale, window = LAYER_CASES[case]
    text = _layer_xconfig(decay)
    port_layer = build_model_from_string(text).layer_map["l"]
    ref_layer = ref.parse(text).by_name["l"]
    B, T, origin, defined = 5, 44, 20, 2
    g = torch.Generator().manual_seed(11)
    weights = ref.make_weights(ref.parse(text), 3, "cpu")["l"]
    weights = {k: (v + 0.1 * torch.randn(v.shape, generator=g))
               for k, v in weights.items()}
    x = torch.randn((B, T, 12), generator=g)
    up = torch.randn((B, T - defined, 14), generator=g) * gscale
    chunk = ChunkTimes(origin, *(window or (None, None)))
    if window is not None:
        # the network zeroes the layer output's derivative outside the
        # window (its _DerivWindow); the layer's own recurrence does the rest
        t = torch.arange(defined, T)
        up = up * ((t >= window[0]) & (t <= window[1]))[None, :, None]

    def port():
        p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        xs = x.clone().requires_grad_(True)
        y = _fwd_fast_lstmp(port_layer.spec, p, xs, torch.float32, 1, 0,
                            defined, chunk)[:, defined:]
        (y * up).sum().backward()
        return [y.detach(), xs.grad[:, defined:]] + [p[k].grad
                                                      for k in sorted(p)]

    def reference():
        p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        xs = x.clone().requires_grad_(True)
        y = ref._lstmp(ref_layer, p, ref.Frames(xs[:, defined:], defined),
                       origin, window, None, ()).x
        (y * up).sum().backward()
        return [y.detach(), xs.grad[:, defined:]] + [p[k].grad
                                                      for k in sorted(p)]

    got, want = port(), reference()
    gaps = [_rel(a, b) for a, b in zip(got, want)]
    assert max(gaps) < 1e-5, gaps
    if window is not None:
        assert got[1][:, :window[0] - defined].abs().max() == 0


TINY = """\
input dim=6 name=ivector
input dim=5 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=16
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=16
fast-lstmp-layer name=lstm1 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
relu-renorm-layer name=tdnn3 input=Append(-3,0,3) dim=16
fast-lstmp-layer name=lstm2 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
output-layer name=output input=lstm2 output-delay=5 include-log-softmax=false dim=12
output-layer name=output-xent input=lstm2 output-delay=5 dim=12
"""


def _tiny_net():
    model = build_model_from_string(TINY)
    net = Network(model, torch.Generator().manual_seed(1), device="cpu")
    weights = ref.make_weights(ref.parse(TINY), 7, "cpu")
    with torch.no_grad():
        for l, p in weights.items():
            for k, w in p.items():
                net.params[l][k].copy_(w)
    return model, net, weights


def test_tiny_network_on_the_grid():
    """A tiny TDNN-LSTM (cell-dim 32, output-delay 5) on the frame grid
    against the reference at the supervised frames, outputs and every
    gradient under a derivative window, and against its own full-rate
    forward there."""
    model, net, weights = _tiny_net()
    assert grid_delay(model, grid_layers(model, 3)) == 5
    assert model.time_context() == (11, 1)
    B, T, left, n_out, margin = 3, 48, 20, 8, 2
    g = torch.Generator().manual_seed(5)
    feats, ivecs = torch.randn((B, T, 5), generator=g), \
        torch.randn((B, 6), generator=g)
    up = torch.randn((B, n_out, 12), generator=g)
    window = (left - margin - 11, left + 3 * (n_out - 1) + margin + 1)
    n_grid = (T - 3) // 3 + 1
    outs, _ = net(feats, ivecs, train=True, compute_dtype=torch.float32,
                  time_subsample=(3, left % 3, n_grid),
                  chunk=ChunkTimes(left, *window))
    s = left // 3
    got = {k: v[:, s:s + n_out] for k, v in outs.items()}
    (got["output"] * up).sum().backward()
    grads = {(l, k): w.grad for l, p in net.params.items()
             for k, w in p.items() if l != "lda"}
    leaves = {l: {k: w.clone().requires_grad_(l != "lda")
                  for k, w in p.items()} for l, p in weights.items()}
    want = ref.forward(ref.parse(TINY), leaves, feats, ivecs, left, n_out, 3,
                       window)
    (want["output"] * up).sum().backward()
    for k in ("output", "output-xent"):
        assert _rel(got[k].detach(), want[k].detach()) < 1e-5, k
    for (l, k), gr in grads.items():
        if l == "output-xent":              # outside the loss: no gradient
            assert gr is None and leaves[l][k].grad is None
            continue
        assert _rel(gr, leaves[l][k].grad) < 1e-5, (l, k)
    with torch.no_grad():
        full, _ = net(feats, ivecs, train=True, compute_dtype=torch.float32)
    sup = full["output"][:, left:left + 3 * (n_out - 1) + 1:3]
    assert _rel(sup, got["output"].detach()) < 1e-6


def test_flagship_grid_is_unchanged():
    """Without an output-delay the grid's frames are the supervised ones,
    offset + k * stride, every frame to the chunk's edges: a pointwise
    model on the grid equals its full-rate forward there exactly, and the
    flagship's grid has no delay."""
    from pathlib import Path
    from kaldi_fp16_tpu_torch.models.model import build_model
    root = Path(__file__).resolve().parents[1]
    flagship = build_model(str(root / "configs" / "cnn_tdnn.xconfig"))
    assert grid_delay(flagship, grid_layers(flagship, 3)) == 0
    model = build_model_from_string(
        "input dim=7 name=input\n"
        "linear-component name=lin dim=9\n"
        "output-layer name=output include-log-softmax=false dim=4\n")
    net = Network(model, torch.Generator().manual_seed(2), device="cpu")
    feats = torch.randn((2, 31, 7), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full, _ = net(feats, compute_dtype=torch.float32)
        for left in (3, 4, 5):
            n_grid = (31 - 3) // 3 + 1
            grid, _ = net(feats, compute_dtype=torch.float32,
                          time_subsample=(3, left % 3, n_grid),
                          chunk=ChunkTimes(left))
            want = full["output"][:, left % 3::3][:, :n_grid]
            assert torch.equal(grid["output"], want)


def test_natural_gradient_refuses_lstmp():
    from kaldi_fp16_tpu_torch.training.train_step import (
        TrainConfig, init_train_state,
    )
    model = build_model_from_string(TINY)
    with pytest.raises(NotImplementedError, match="fast-lstmp"):
        ng_sites(model)
    with pytest.raises(NotImplementedError, match="fast-lstmp"):
        init_train_state(model, torch.Generator().manual_seed(0),
                         TrainConfig(natural_gradient=True), "cpu")


def test_trainer_runs_tdnn_lstm_without_ng():
    """The Trainer trains a tiny TDNN-LSTM for two steps on the CPU
    (SGD, derivative margin, no NG): finite losses, moved weights, the LDA
    held."""
    import numpy as np
    from benchmark.drivers.step_recurrent import _port_graph
    from benchmark.traffic.step_batches import make_batch
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    from kaldi_fp16_tpu_torch.io.batch import ChainBatch
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer
    model = build_model_from_string(TINY)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_phone_lm_den_fst(num_pdfs=12, num_phones=6, branching=3,
                              seed=1), 12), device="cpu")
    cfg = TrainConfig(learning_rate=0.01, momentum=0.9, left_context=20,
                      compute_dtype="float32", deriv_truncate_margin=2)
    trainer = Trainer(model, den, cfg, device="cpu")
    lda = trainer.net.params["lda"]["w"].detach().clone()
    w0 = trainer.net.params["lstm1"]["w_all"].detach().clone()
    losses = []
    for k in range(2):
        b = make_batch(9, k, 3, 48, 8, 12, 5, 6, 20, 3, torch.device("cpu"))
        batch = ChainBatch(
            features=b["features"].numpy(), ivectors=b["ivectors"].numpy(),
            weights=np.ones(3, np.float32),
            deriv_weights=np.ones((3, 8), np.float32),
            num_graph=_port_graph(b["num"], torch.device("cpu")),
            frames_per_seq=8, left_context=20, keys=["a", "b", "c"])
        out = trainer.train_batch(batch)
        losses.append(float(out.loss))
    assert all(math.isfinite(v) for v in losses)
    assert torch.equal(trainer.net.params["lda"]["w"], lda)
    assert not torch.equal(trainer.net.params["lstm1"]["w_all"], w0)


@pytest.mark.gpu
def test_cuda_den_pads_a_64_row_batch():
    """The TDNN-LSTM cell's B 64 on the card: the structured den pads the
    batch to the fused scans' 128-row tile and matches the loop den at
    the same 64 rows (the scans' bars of tests/test_torch_den_scan.py:
    log-probs to 1e-5 relative, posteriors to 1e-4 / 1e-6)."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    dev = _card()
    g = DenominatorGraph.from_fst(make_phone_lm_den_fst(
        num_pdfs=300, num_phones=200, branching=12, seed=3), 300)
    x = torch.randn((64, 20, 300), generator=torch.Generator(dev)
                    .manual_seed(1), device=dev)
    fused = DenominatorComputation(g, leaky=1e-5, device=dev)
    lp_f, post_f = fused.forward_backward(x)
    assert fused._structured.scan_used == "fused"
    loop = DenominatorComputation(g, leaky=1e-5, scan_impl="loop", device=dev)
    lp_l, post_l = loop.forward_backward(x)
    assert loop._structured.scan_used == "loop"
    torch.testing.assert_close(lp_f, lp_l, rtol=1e-5, atol=0)
    torch.testing.assert_close(post_f, post_l, rtol=1e-4, atol=1e-6)
