"""Kaldi's TDNN-BLSTM on the port: fast-lstmp layers with a positive delay
walk backward in time (ops/lstmp.py's reverse walk, csrc/lstmp.cu's
`lstmp_rev_*` kernels), from the last frame at which their input is
defined, so that a chunk's right context reaches the supervised frames.

CPU tests hold the port's plain path against the benchmark's plain float32
reference (benchmark/reference/tdnn_blstm.py, written from Kaldi's
equations): one reverse layer's outputs, input derivative and gradients,
and a tiny TDNN-BLSTM on the grid, to float32 rounding (1e-5 relative).
The TDNN-LSTM's recurrences keep the steps they had before the reverse
walk came.

The `gpu` tests hold the reverse kernels against the plain loop on the
card, forward and backward, in bf16 and float32, at the benchmark cell's
layer shape and a ragged one:
`python -m pytest --noconftest -m gpu tests/test_torch_blstm.py`.
"""

import math

import pytest
import torch

from benchmark.reference import tdnn_blstm as ref
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import (
    ChunkTimes, Network, _fwd_fast_lstmp, grid_delay, grid_layers,
)
from kaldi_fp16_tpu_torch.models.xconfig import LayerType, parse_xconfig
from kaldi_fp16_tpu_torch.ops import lstmp as lstmp_ops
from kaldi_fp16_tpu_torch.ops.lstmp import (
    LstmpSteps, lstmp_recurrence, lstmp_recurrence_plain,
)

# the recipe's own lines (run_tdnn_blstm_1a.sh's network.xconfig, with its
# shell variables filled in: lstm_opts decay-time=20, label_delay 0)
RECIPE = """\
input dim=100 name=ivector
input dim=40 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0)) affine-transform-file=exp/chain/tdnn_blstm_1a_sp/configs/lda.mat
relu-renorm-layer name=tdnn1 dim=1024
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=1024
relu-renorm-layer name=tdnn3 input=Append(-1,0,1) dim=1024
fast-lstmp-layer name=blstm1-forward input=tdnn3 cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256 delay=-3 decay-time=20
fast-lstmp-layer name=blstm1-backward input=tdnn3 cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256 delay=3 decay-time=20
fast-lstmp-layer name=blstm2-forward input=Append(blstm1-forward, blstm1-backward) cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256 delay=-3 decay-time=20
fast-lstmp-layer name=blstm2-backward input=Append(blstm1-forward, blstm1-backward) cell-dim=1024 recurrent-projection-dim=256 non-recurrent-projection-dim=256 delay=3 decay-time=20
output-layer name=output input=Append(blstm2-forward, blstm2-backward) output-delay=0 include-log-softmax=false dim=3080 max-change=1.5
output-layer name=output-xent input=Append(blstm2-forward, blstm2-backward) output-delay=0 dim=3080 learning-rate-factor=5.0 max-change=1.5
"""


def test_recipe_lines_parse():
    cfgs = parse_xconfig(RECIPE)
    assert [c.type for c in cfgs].count(LayerType.FAST_LSTMP) == 4
    model = build_model_from_string(RECIPE)
    fwd = model.layer_map["blstm1-forward"].spec
    bwd = model.layer_map["blstm1-backward"].spec
    assert (fwd.delay, bwd.delay) == (-3, 3)
    assert math.isclose(bwd.scale, 0.85) and math.isclose(fwd.scale, 0.85)
    assert (bwd.cell_dim, bwd.recurrent_dim, bwd.nonrecurrent_dim) == \
        (1024, 256, 256)
    b2 = model.layer_map["blstm2-backward"]
    assert b2.input.names == ["blstm1-forward", "blstm1-backward"]
    assert b2.input.offsets == [0, 0] and b2.input_dim == 1024
    out = model.layer_map["output"]
    assert out.input_dim == 1024 and out.spec.output_delay == 0
    assert model.time_context() == (4, 4)


def test_delay_zero_is_refused():
    with pytest.raises(ValueError, match="delay must be nonzero"):
        build_model_from_string(
            "input dim=8 name=input\n"
            "fast-lstmp-layer name=l cell-dim=16 delay=0\n"
            "output-layer name=output dim=4\n")


def test_benchmark_model_context_and_size():
    """The configuration's model: context 4 / 4, and the recipe's header
    counts reproduced at its ~6,067 targets (53,688,166 for 1a, and
    41,155,430 for 6k: the same BLSTM layers on the LDA, without the
    TDNNs)."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    text = (root / "benchmark" / "configs" / "tdnn_blstm.xconfig").read_text()
    model = build_model_from_string(text)
    assert model.time_context() == (4, 4)
    assert model.num_params() == 47_564_816
    wide = text.replace("dim=3080", "dim=6067")
    assert build_model_from_string(wide).num_params() == 53_688_166
    six_k = "\n".join(line for line in wide.splitlines()
                      if not line.startswith("relu-renorm-layer"))
    six_k = six_k.replace("input=tdnn3", "input=lda")
    assert build_model_from_string(six_k).num_params() == 41_155_430


# ---------------------------------------------------------------------------
# The plain path against the reference (CPU, float32)
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _layer_xconfig(decay):
    return ("input dim=12 name=input\n"
            "fast-lstmp-layer name=l cell-dim=32 recurrent-projection-dim=8 "
            f"non-recurrent-projection-dim=6 delay=3 decay-time={decay}\n"
            "output-layer name=output dim=5\n")


# decay-time, upstream derivative scale, derivative window (None: none):
# s = 1 and s = 0.85 at derivatives under the thresholds, derivatives that
# clip every row, ones that cross the zeroing threshold but not the clip,
# and the margin cutting the right context (the walk's first frames)
LAYER_CASES = {
    "s1": (-1, 0.05, None),
    "decay": (20, 0.05, None),
    "clip": (20, 200.0, None),
    "zeroing": (20, 10.0, None),
    "right_margin": (20, 0.05, (2, 30)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_reverse_layer_against_reference(case):
    """One reverse fast-lstmp layer at the full frame rate (delay +3
    frames), its walk from the last defined frame: the port's plain path
    (network._fwd_fast_lstmp, ops.lstmp's loop) against the reference,
    outputs, input derivative and every gradient."""
    decay, gscale, window = LAYER_CASES[case]
    text = _layer_xconfig(decay)
    port_layer = build_model_from_string(text).layer_map["l"]
    ref_layer = ref.parse(text).by_name["l"]
    B, T, origin, last = 5, 44, 9, 39      # frames 40-43 undefined
    g = torch.Generator().manual_seed(11)
    weights = ref.make_weights(ref.parse(text), 3, "cpu")["l"]
    weights = {k: (v + 0.1 * torch.randn(v.shape, generator=g))
               for k, v in weights.items()}
    x = torch.randn((B, T, 12), generator=g)
    up = torch.randn((B, last + 1, 14), generator=g) * gscale
    chunk = ChunkTimes(origin, *(window or (None, None)))
    if window is not None:
        t = torch.arange(last + 1)
        up = up * ((t >= window[0]) & (t <= window[1]))[None, :, None]

    def port():
        p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        xs = x.clone().requires_grad_(True)
        y = _fwd_fast_lstmp(port_layer.spec, p, xs, torch.float32, 1, 0, 0,
                            chunk, last)[:, :last + 1]
        (y * up).sum().backward()
        return [y.detach(), xs.grad[:, :last + 1]] + [p[k].grad
                                                      for k in sorted(p)]

    def reference():
        p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        xs = x.clone().requires_grad_(True)
        xw = ref._mm(xs[:, :last + 1], p["w_all"][:12], None) + p["b_all"]
        y, _ = ref.walk(ref_layer, xw, p["w_all"][12:], p["peephole"],
                        p["w_rp"], p["b_rp"], 0, last, origin, last, window,
                        None, ())
        (y * up).sum().backward()
        return [y.detach(), xs.grad[:, :last + 1]] + [p[k].grad
                                                      for k in sorted(p)]

    got, want = port(), reference()
    gaps = [_rel(a, b) for a, b in zip(got, want)]
    assert max(gaps) < 1e-5, gaps
    if window is not None:
        assert got[1][:, window[1] + 1:].abs().max() == 0


def test_reverse_walk_starts_at_the_last_defined_step():
    """A reverse recurrence's state is zero past `start`, and its outputs
    are zero there; the frames before start read their successors."""
    B, T, C, R = 2, 9, 8, 4
    g = torch.Generator().manual_seed(3)
    z = torch.randn((B, T, 4 * C), generator=g)
    w = [torch.randn((R, 4 * C), generator=g) * 0.3,
         torch.randn((3, C), generator=g) * 0.3,
         torch.randn((C, R), generator=g) * 0.3, torch.zeros(R)]
    steps = LstmpSteps(start=6, delay=2, scale=0.85, reverse=True,
                       bf16_ops=False)
    r, m = lstmp_recurrence_plain(z, *w, steps)
    assert r[:, 7:].abs().max() == 0 and m[:, 7:].abs().max() == 0
    # step 6 and 5 have no successor on the walk: their cell is the
    # zero-state one, whatever z holds after them
    z2 = z.clone()
    z2[:, 7:] = 100.0
    r2, _ = lstmp_recurrence_plain(z2, *w, steps)
    assert torch.equal(r, r2)
    # the forward walk over the frames in the other order
    ahead = LstmpSteps(start=0, delay=2, scale=0.85, bf16_ops=False)
    r_fwd, m_fwd = lstmp_recurrence_plain(z[:, :7].flip(1), *w, ahead)
    assert torch.equal(r[:, :7], r_fwd.flip(1))
    assert torch.equal(m[:, :7], m_fwd.flip(1))
    assert steps.window(T) == (0, 6)
    assert list(steps.walk(T)) == [6, 5, 4, 3, 2, 1, 0]


TINY = """\
input dim=6 name=ivector
input dim=5 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=16
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=16
fast-lstmp-layer name=blstm1-forward input=tdnn2 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
fast-lstmp-layer name=blstm1-backward input=tdnn2 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=3 decay-time=20
fast-lstmp-layer name=blstm2-forward input=Append(blstm1-forward, blstm1-backward) cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
fast-lstmp-layer name=blstm2-backward input=Append(blstm1-forward, blstm1-backward) cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=3 decay-time=20
output-layer name=output input=Append(blstm2-forward, blstm2-backward) output-delay=0 include-log-softmax=false dim=12
output-layer name=output-xent input=Append(blstm2-forward, blstm2-backward) output-delay=0 dim=12
"""


def _tiny_net(text=TINY):
    model = build_model_from_string(text)
    net = Network(model, torch.Generator().manual_seed(1), device="cpu")
    weights = ref.make_weights(ref.parse(text), 7, "cpu")
    with torch.no_grad():
        for l, p in weights.items():
            for k, w in p.items():
                net.params[l][k].copy_(w)
    return model, net, weights


@pytest.mark.parametrize("margin", [2, None])
def test_tiny_blstm_on_the_grid(margin):
    """A tiny TDNN-BLSTM (two BLSTM layers, cell-dim 32) on the frame grid
    against the reference at the supervised frames, outputs and every
    gradient (under a derivative window, and without one), and against
    its own full-rate forward there."""
    model, net, weights = _tiny_net()
    assert grid_delay(model, grid_layers(model, 3)) == 0
    assert model.time_context() == (3, 3)
    B, left, n_out, right = 3, 13, 8, 13     # 10 frames of context a side
    T = left + 3 * (n_out - 1) + 1 + right
    g = torch.Generator().manual_seed(5)
    feats, ivecs = torch.randn((B, T, 5), generator=g), \
        torch.randn((B, 6), generator=g)
    up = torch.randn((B, n_out, 12), generator=g)
    window = (None if margin is None else
              (left - margin - 3, left + 3 * (n_out - 1) + margin + 3))
    n_grid = (T - 3) // 3 + 1
    outs, _ = net(feats, ivecs, train=True, compute_dtype=torch.float32,
                  time_subsample=(3, left % 3, n_grid),
                  chunk=ChunkTimes(left, *(window or (None, None))))
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


def test_right_context_reaches_the_supervised_frames():
    """The reverse walks carry the right context in: features changed
    only past the last supervised frame move the outputs, and the
    reference's `right_edge` fault (walks started at the last supervised
    frame) leaves them where the right context would not."""
    model, net, weights = _tiny_net()
    B, left, n_out, right = 2, 13, 6, 13
    T = left + 3 * (n_out - 1) + 1 + right
    g = torch.Generator().manual_seed(8)
    feats, ivecs = torch.randn((B, T, 5), generator=g), \
        torch.randn((B, 6), generator=g)
    moved = feats.clone()
    moved[:, left + 3 * (n_out - 1) + 4:] += 1.0     # past what tdnn reach
    n_grid = (T - 3) // 3 + 1

    def run(f):
        with torch.no_grad():
            o, _ = net(f, ivecs, compute_dtype=torch.float32,
                       time_subsample=(3, left % 3, n_grid),
                       chunk=ChunkTimes(left))
        return o["output"][:, left // 3:left // 3 + n_out]
    assert _rel(run(moved), run(feats)) > 1e-4
    model_ref = ref.parse(TINY)
    with torch.no_grad():
        a = ref.forward(model_ref, weights, feats, ivecs, left, n_out, 3,
                        faults=("right_edge",))["output"]
        b = ref.forward(model_ref, weights, moved, ivecs, left, n_out, 3,
                        faults=("right_edge",))["output"]
    assert torch.equal(a, b)


# the TDNN-LSTM's fast-lstmp steps at the benchmark cell's geometry (T_in
# 222, left context 61, 50 outputs, margin 8) with the layers narrowed:
# each layer's (start, delay, deriv_lo, deriv_hi, frame0, reverse) as the
# port passed them before the reverse walk came
TDNN_LSTM_STEPS = [(1, 1, 10, 75, -59, False), (3, 1, 10, 75, -59, False),
                   (5, 1, 10, 75, -59, False)]


def test_tdnn_lstm_steps_are_unchanged():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    text = (root / "benchmark" / "configs" / "tdnn_lstm.xconfig").read_text()
    text = (text.replace("dim=1024", "dim=16")
            .replace("cell-dim=1024", "cell-dim=16")
            .replace("projection-dim=256", "projection-dim=4")
            .replace("dim=3080", "dim=12"))
    model = build_model_from_string(text)
    net = Network(model, torch.Generator().manual_seed(1), device="cpu")
    B, T, left, n_out, margin = 2, 222, 61, 50, 8
    seen = []
    lstmp_recurrence.tap = lambda *a: seen.append(a[5])
    try:
        l, r = model.time_context()
        chunk = ChunkTimes(left, left - margin - l,
                           left + 3 * (n_out - 1) + margin + r)
        with torch.no_grad():
            net(torch.zeros((B, T, 40)), torch.zeros((B, 100)), train=True,
                compute_dtype=torch.float32,
                time_subsample=(3, left % 3, (T - 3) // 3 + 1), chunk=chunk)
    finally:
        lstmp_recurrence.tap = None
    got = [(s.start, s.delay, s.deriv_lo, s.deriv_hi, s.frame0, s.reverse)
           for s in seen]
    assert got == TDNN_LSTM_STEPS


def test_trainer_runs_tdnn_blstm_without_ng():
    """The Trainer trains a tiny TDNN-BLSTM for two steps on the CPU (SGD,
    derivative margin, no NG): finite losses, moved weights in both
    directions, the LDA held."""
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
    cfg = TrainConfig(learning_rate=0.01, momentum=0.9, left_context=13,
                      compute_dtype="float32", deriv_truncate_margin=2)
    trainer = Trainer(model, den, cfg, device="cpu")
    lda = trainer.net.params["lda"]["w"].detach().clone()
    w0 = {n: trainer.net.params[n]["w_all"].detach().clone()
          for n in ("blstm1-forward", "blstm1-backward")}
    losses = []
    for k in range(2):
        b = make_batch(9, k, 3, 48, 8, 12, 5, 6, 13, 3, torch.device("cpu"))
        batch = ChainBatch(
            features=b["features"].numpy(), ivectors=b["ivectors"].numpy(),
            weights=np.ones(3, np.float32),
            deriv_weights=np.ones((3, 8), np.float32),
            num_graph=_port_graph(b["num"], torch.device("cpu")),
            frames_per_seq=8, left_context=13, keys=["a", "b", "c"])
        out = trainer.train_batch(batch)
        losses.append(float(out.loss))
    assert all(math.isfinite(v) for v in losses)
    assert torch.equal(trainer.net.params["lda"]["w"], lda)
    for n, w in w0.items():
        assert not torch.equal(trainer.net.params[n]["w_all"], w), n


def test_reverse_spans_and_counters_exist():
    """Eager calls open spans of their own for the reverse layers, and the
    launch counter has a reverse count beside the total."""
    from kaldi_fp16_tpu_torch.utils import spans
    model, net, _ = _tiny_net()
    spans.reset()
    with torch.no_grad():
        net(torch.zeros((1, 30, 5)), torch.zeros((1, 6)),
            compute_dtype=torch.float32)
    snap = spans.snapshot()
    assert len(snap["network.lstmp_reverse"]["start_ns"]) == 2
    assert len(snap["network.lstmp"]["start_ns"]) == 2
    before = (lstmp_recurrence.launches, lstmp_recurrence.reverse_launches)
    lstmp_ops._count(LstmpSteps(reverse=True))
    lstmp_ops._count(LstmpSteps())
    assert (lstmp_recurrence.launches - before[0],
            lstmp_recurrence.reverse_launches - before[1]) == (2, 1)


# ---------------------------------------------------------------------------
# The reverse kernels on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the recurrence kernel is CUDA only")
    return torch.device("cuda")


def _inputs(B, T, C, R, dev, seed, grad_scale):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    z = rnd(B, T, 4 * C)
    w_r = rnd(R, 4 * C, scale=R ** -0.5)
    peep = rnd(3, C, scale=0.3)
    w_rr = rnd(C, R, scale=C ** -0.5)
    b_r = rnd(R, scale=0.1)
    return ([z, w_r, peep, w_rr, b_r], rnd(B, T, R, scale=grad_scale),
            rnd(B, T, C, scale=grad_scale))


def _run(fn, leaves, g_r, g_m, steps):
    xs = [x.clone().requires_grad_(True) for x in leaves]
    r, m = fn(*xs, steps)
    torch.autograd.backward([r, m], [g_r, g_m])
    return [r.detach(), m.detach()] + [x.grad for x in xs]


# B, T, C, R, start, delay, window, grad scale: the benchmark cell's layer
# (64 sequences, 79 grid steps, the walk from step 77, the derivative
# window 10 .. 67, derivatives large enough to clip and zero), and a
# ragged one with full-rate delay 3
CARD_CASES = {
    "cell": (64, 79, 1024, 256, 77, 1, (10, 67), 3.0),
    "ragged": (3, 9, 40, 12, 7, 3, (1, 6), 30.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_reverse_kernel_against_plain(case, bf16):
    """The reverse kernels against the plain loop on the card, repeats
    bit-identical, one launch a pass, both counted as reverse; the bars
    are test_torch_lstmp.py's for the forward walk (the same arithmetic
    in the other order of steps)."""
    dev = _card()
    B, T, C, R, start, delay, (lo, hi), gs = CARD_CASES[case]
    leaves, g_r, g_m = _inputs(B, T, C, R, dev, 7, gs)
    steps = LstmpSteps(start=start, delay=delay, scale=0.85, deriv_lo=lo,
                       deriv_hi=hi, recurrence_frames=3, frame0=-42,
                       frame_step=3 if delay == 1 else 1, bf16_ops=bf16,
                       reverse=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = _run(lstmp_recurrence_plain, leaves, g_r, g_m, steps)
    before = (lstmp_recurrence.launches, lstmp_recurrence.reverse_launches)
    kern = _run(lstmp_recurrence, leaves, g_r, g_m, steps)
    torch.cuda.synchronize()
    assert (lstmp_recurrence.launches - before[0],
            lstmp_recurrence.reverse_launches - before[1]) == (2, 2)
    again = _run(lstmp_recurrence, leaves, g_r, g_m, steps)
    names = ["r", "m", "dz", "dw_r", "dpeep", "dw_rr", "db_r"]
    gaps = {n: float((k - p).norm() / p.norm().clamp(min=1e-30))
            for n, k, p in zip(names, kern, plain)}
    bars = ({n: 5e-3 for n in names} if bf16
            else dict({n: 1e-4 for n in names}, r=2e-5, m=2e-5))
    assert all(v < bars[n] for n, v in gaps.items()), gaps
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    assert kern[0][:, start + 1:].abs().sum() == 0
    assert kern[2][:, :lo].abs().sum() == 0
    assert kern[2][:, hi + 1:].abs().sum() == 0
