"""The train step replayed as a CUDA graph against the eager step, bit for
bit (training/train_step.py).

`graph_vs_eager` runs one sequence of calls twice from the same state,
once eagerly (`train_step._GRAPHS = False`) and once with the graphs, and
asserts that every call's outputs, the parameters, the BatchNorm
statistics, the velocities and the step count come out with the same
bits.  The sequence crosses two orthonormal steps (interval 4), has a
skipped call (a non-finite feature), alternates two batches with
different numerator graphs, draws SpecAugment masks from a generator on
the step's device, and is given a foreign opt_state (a copy) half way.
Each call's kernel launches (the counters of `_LAUNCH_COUNTERS`) must
match too.

On the CPU the graph API is replaced by a stand-in that records the
step's body at capture and runs it at each replay, which holds the
static buffers, the copy-in, the state handling and the constraint's
schedule to the eager step.  On a card (`-m gpu`, jax-free: run with
`--noconftest`) the real graphs run: a small CNN-TDNN-F, a small
TDNN-LSTM (the recurrence's cooperative kernels) and a small TDNN-BLSTM
(their reverse walks).  chip_smoke.py's
`train_graph` phase runs `graph_vs_eager` at flagship width.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.drivers.step_recurrent import _port_graph
from benchmark.traffic.step_batches import make_batch
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.models.model import build_model_from_string
from kaldi_fp16_tpu_torch.models.network import Network
from kaldi_fp16_tpu_torch.training import train_step as ts
from kaldi_fp16_tpu_torch.training.loss_scale import init_loss_scale
from kaldi_fp16_tpu_torch.training.optimizer import init_sgd_state

# a narrow CNN-TDNN-F: SpecAugment, convs, TDNN-F (orthonormal targets),
# prefinal, both heads
CNN_XCONFIG = """\
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
spec-augment-layer name=idct-spec-augment input=idct-batchnorm freq-max-proportion=0.5 time-zeroed-proportion=0.2 time-mask-max-frames=4
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-spec-augment, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf4 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim=24
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim=24 learning-rate-factor=5.0
"""

# a narrow TDNN-LSTM: two fast-lstmp layers (C and R multiples of 4)
LSTM_XCONFIG = """\
input dim=10 name=ivector
input dim=8 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=32
relu-renorm-layer name=tdnn2 input=Append(-1,0,1) dim=32
fast-lstmp-layer name=lstm1 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
relu-renorm-layer name=tdnn3 input=Append(-3,0,3) dim=32
fast-lstmp-layer name=lstm2 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
output-layer name=output input=lstm2 output-delay=5 include-log-softmax=false dim=24
output-layer name=output-xent input=lstm2 output-delay=5 dim=24
"""

# a narrow TDNN-BLSTM: one layer each way (the reverse walk's kernels)
BLSTM_XCONFIG = """\
input dim=10 name=ivector
input dim=8 name=input
fixed-affine-layer name=lda input=Append(-2,-1,0,1,2,ReplaceIndex(ivector, t, 0))
relu-renorm-layer name=tdnn1 dim=32
fast-lstmp-layer name=blstm1-forward cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=-3 decay-time=20
fast-lstmp-layer name=blstm1-backward input=tdnn1 cell-dim=32 recurrent-projection-dim=8 non-recurrent-projection-dim=8 delay=3 decay-time=20
output-layer name=output input=Append(blstm1-forward, blstm1-backward) include-log-softmax=false dim=24
output-layer name=output-xent input=Append(blstm1-forward, blstm1-backward) dim=24
"""

CALLS = 10          # calls 4 and 9 take the constraint (interval 4)
BAD_CALL = 5        # a non-finite feature: skipped
FOREIGN_CALL = 7    # given a copy of its opt_state
FIELDS = ("loss", "objf_per_frame", "num_logprob", "den_logprob",
          "xent_objf", "param_change_norm", "grad_norm", "loss_scale",
          "skipped", "ok", "weight_frames")


def small_den(pdfs: int, device) -> DenominatorComputation:
    return DenominatorComputation(DenominatorGraph.from_fst(
        make_phone_lm_den_fst(num_pdfs=pdfs, num_phones=12,
                              states_per_phone=2, branching=4, seed=0),
        pdfs), leaky=1e-5, device=device)


def make_calls(device, B, T_in, T_out, pdfs, feat_dim, ivec_dim, left,
               seed=11) -> list:
    """CALLS (batch, numerator graph) pairs: two batches with different
    numerator graphs in turn (the second's arrays on the host), and a copy
    of the first with one non-finite feature at BAD_CALL."""
    made = [make_batch(seed, k, B, T_in, T_out, pdfs, feat_dim, ivec_dim,
                       left, 3, device) for k in range(2)]
    pairs = [({n: b[n] for n in ts.BATCH_KEYS}, _port_graph(b["num"], device))
             for b in made]
    host = {f: getattr(pairs[1][1], f).cpu().numpy() for f in ts._NUM_FIELDS}
    pairs[1] = (pairs[1][0], dataclasses.replace(pairs[1][1], **host))
    bad = dict(pairs[0][0], features=pairs[0][0]["features"].clone())
    bad["features"][0, T_in // 2, 1] = float("nan")
    return [(bad, pairs[0][1]) if call == BAD_CALL else pairs[(call - 1) % 2]
            for call in range(1, CALLS + 1)]


def _bits(t: torch.Tensor) -> bytes:
    return (t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
            .numpy().tobytes())


def _launches() -> list:
    return [getattr(h, a) for h, a in ts._LAUNCH_COUNTERS]


def _run(graphs: bool, model, den, calls, device, config,
         T_out: int) -> dict:
    net = Network(model, torch.Generator().manual_seed(0), device)
    opt = init_sgd_state(net.params)
    scale = init_loss_scale(1.0, device=device)
    step = ts.make_train_step(model, net, den, None, ChainTrainingOpts(),
                              config, num_frames_out=T_out)
    gen = torch.Generator(device=device).manual_seed(5)
    outs, launches, skipped = [], [], []
    saved, ts._GRAPHS = ts._GRAPHS, graphs
    try:
        for call, (batch, num) in enumerate(calls, 1):
            if call == FOREIGN_CALL:
                opt = {"velocity": {l: {k: v.clone() for k, v in p.items()}
                                    for l, p in opt["velocity"].items()},
                       "step": opt["step"].clone()}
            before = _launches()
            opt, scale, out = step(opt, scale, batch, generator=gen,
                                   num_graph=num)
            launches.append([a - b for a, b in zip(_launches(), before)])
            outs.append({f: _bits(getattr(out, f)) for f in FIELDS})
            skipped.append(bool(out.skipped))
    finally:
        ts._GRAPHS = saved
    state = {f"net/{k}": _bits(v) for k, v in net.state_dict().items()}
    state.update({f"velocity/{l}/{k}": _bits(v)
                  for l, p in opt["velocity"].items() for k, v in p.items()})
    state["step"] = _bits(opt["step"])
    return {"outs": outs, "launches": launches, "state": state,
            "skipped": skipped,
            "step_count": int(opt["step"]),
            "counts": {"blocking_reads": step.blocking_reads,
                       "graph_captures": step.graph_captures,
                       "graph_replays": step.graph_replays}}


def graph_vs_eager(model, den, calls, device, T_out: int, left: int,
                   margin=None, dtype="bfloat16") -> dict:
    """Run `calls` eagerly and with the graphs (see the module docstring)
    and assert them bit-identical; returns the graph run's counts."""
    config = ts.TrainConfig(learning_rate=0.01, momentum=0.9,
                            frame_subsampling_factor=3, left_context=left,
                            compute_dtype=dtype, orthonormal_interval=4,
                            deriv_truncate_margin=margin)
    eager = _run(False, model, den, calls, device, config, T_out)
    graph = _run(True, model, den, calls, device, config, T_out)
    for call, (e, g) in enumerate(zip(eager["outs"], graph["outs"]), 1):
        differ = [f for f in FIELDS if e[f] != g[f]]
        assert not differ, f"call {call}: outputs {differ} differ"
    differ = [k for k in eager["state"] if eager["state"][k] !=
              graph["state"][k]]
    assert not differ, f"the states differ at {differ[:8]}"
    assert eager["launches"] == graph["launches"], (
        f"launches a call: eager {eager['launches']}, "
        f"graphed {graph['launches']}")
    assert eager["skipped"] == graph["skipped"]
    assert graph["skipped"] == [c == BAD_CALL for c in range(1, CALLS + 1)]
    assert eager["step_count"] == graph["step_count"] == CALLS - 1
    assert eager["counts"] == {"blocking_reads": 2, "graph_captures": 0,
                               "graph_replays": 0}
    return graph["counts"]


# ---------------------------------------------------------------------------
# The CPU: the graph API's stand-in
# ---------------------------------------------------------------------------

class _RecordedGraph:
    """Capture records the body; replay runs it and writes what it returns
    into the buffers capture handed out (a graph's static outputs)."""

    def __init__(self):
        self.body, self.outs = None, None

    def register_generator_state(self, generator):
        pass

    def replay(self):
        new = self.body()
        if new is None:
            return
        if not self.outs:
            self.outs.extend(new)
        else:
            for (old, _), (fresh, _) in zip(self.outs, new):
                old.copy_(fresh)


def _record(graph, pool, body):
    graph.body, graph.outs = body, []
    return graph.outs


@pytest.fixture
def recorded_graphs(monkeypatch):
    """The step's graph path on the CPU, through `_RecordedGraph`."""
    real = ts.graph_eligible

    def eligible(device, ng, group, config, lr, spec_masks, generator,
                 batch_devices=()):
        return real(torch.device("cuda"), ng, group, config, lr, spec_masks,
                    None)
    monkeypatch.setattr(ts, "graph_eligible", eligible)
    monkeypatch.setattr(ts, "_new_pool", object)
    monkeypatch.setattr(ts, "_new_graph", _RecordedGraph)
    monkeypatch.setattr(ts, "_record", _record)


def test_recorded_graph_path_equals_the_eager_step_on_the_cpu(
        recorded_graphs):
    cpu = torch.device("cpu")
    calls = make_calls(cpu, 2, 30, 9, 24, 8, 10, 3)
    counts = graph_vs_eager(build_model_from_string(CNN_XCONFIG),
                            small_den(24, cpu), calls, cpu, 9, 3,
                            dtype="float32")
    # call 1 eager, call 2 captures, every later call replays; the seed
    # and the foreign state read the device
    assert counts == {"blocking_reads": 2, "graph_captures": 1,
                      "graph_replays": CALLS - 1}


def test_recorded_graph_path_equals_the_eager_tdnn_lstm_step_on_the_cpu(
        recorded_graphs):
    cpu = torch.device("cpu")
    calls = make_calls(cpu, 2, 48, 8, 24, 8, 10, 20)
    counts = graph_vs_eager(build_model_from_string(LSTM_XCONFIG),
                            small_den(24, cpu), calls, cpu, 8, 20, margin=2,
                            dtype="float32")
    assert counts["graph_captures"] == 1


def test_recorded_graph_path_equals_the_eager_tdnn_blstm_step_on_the_cpu(
        recorded_graphs):
    cpu = torch.device("cpu")
    calls = make_calls(cpu, 2, 48, 8, 24, 8, 10, 20)
    counts = graph_vs_eager(build_model_from_string(BLSTM_XCONFIG),
                            small_den(24, cpu), calls, cpu, 8, 20, margin=2,
                            dtype="float32")
    assert counts["graph_captures"] == 1


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the port's "
                    "kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_graph_step_equals_the_eager_step():
    dev = _card()
    calls = make_calls(dev, 128, 30, 9, 24, 8, 10, 3)
    counts = graph_vs_eager(build_model_from_string(CNN_XCONFIG),
                            small_den(24, dev), calls, dev, 9, 3)
    assert counts == {"blocking_reads": 2, "graph_captures": 1,
                      "graph_replays": CALLS - 1}


@pytest.mark.gpu
def test_cuda_graph_tdnn_lstm_step_equals_the_eager_step():
    dev = _card()
    calls = make_calls(dev, 64, 48, 8, 24, 8, 10, 20)
    counts = graph_vs_eager(build_model_from_string(LSTM_XCONFIG),
                            small_den(24, dev), calls, dev, 8, 20, margin=2)
    assert counts["graph_captures"] == 1


@pytest.mark.gpu
def test_cuda_graph_tdnn_blstm_step_equals_the_eager_step():
    """The replayed step counts the reverse walks' launches as the eager
    step does: 4 a call, 2 of them reverse."""
    from kaldi_fp16_tpu_torch.ops.lstmp import lstmp_recurrence
    dev = _card()
    calls = make_calls(dev, 64, 48, 8, 24, 8, 10, 20)
    before = lstmp_recurrence.reverse_launches
    counts = graph_vs_eager(build_model_from_string(BLSTM_XCONFIG),
                            small_den(24, dev), calls, dev, 8, 20, margin=2)
    assert counts["graph_captures"] == 1
    assert lstmp_recurrence.reverse_launches - before == 2 * 2 * CALLS
