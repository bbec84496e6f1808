"""The port's step timer, kernel profile, the train tool's cuDNN scope and
the NG precision tool's record and re-run, on the CPU."""

import time

import pytest
import torch

from kaldi_fp16_tpu_torch.tools.train import deterministic_cudnn
from kaldi_fp16_tpu_torch.utils.profiling import StepTimer, kernel_times


def test_step_timer_loop_is_one_window_over_the_timed_steps():
    """loop_mean_ms spans the first timed step's start to the last one's
    end (the gaps between steps included) over the same steps as the
    per-step times; the warm-up steps are left out of both."""
    timer = StepTimer(skip_first=2)
    block_s, gap_s, timed = 0.02, 0.03, 4
    for i in range(2 + timed):
        if i == 2:
            before_first = time.perf_counter()
        with timer:
            if i == 2:
                in_first = time.perf_counter()
            time.sleep(block_s)
            in_last = time.perf_counter()
        after_last = time.perf_counter()
        time.sleep(gap_s if i < 1 + timed else 0.0)
    s = timer.summary()
    assert s["steps"] == timed
    assert s["mean_ms"] >= block_s * 1e3
    window_ms = s["loop_mean_ms"] * timed
    assert (in_last - in_first) * 1e3 <= window_ms \
        <= (after_last - before_first) * 1e3
    assert window_ms >= (timed * block_s + (timed - 1) * gap_s) * 1e3
    # the loop's share outside the steps is the gaps' (3 of 4 * 0.05 s),
    # well under the 0.05 s of a missing or extra interval
    outside_ms = window_ms - s["mean_ms"] * timed
    assert outside_ms == pytest.approx((timed - 1) * gap_s * 1e3,
                                       abs=0.5 * gap_s * 1e3)
    assert not any(k.startswith("device_") or k == "idle_share" for k in s)


def test_step_timer_without_timed_steps():
    timer = StepTimer(skip_first=1)
    with timer:
        pass
    assert timer.summary() == {"steps": 0}


def test_kernel_times_on_the_cpu_names_the_operators():
    a = torch.randn(64, 64)
    wall, rows = kernel_times(lambda: a @ a, "cpu")
    assert wall > 0
    assert any("mm" in name for name, _, _ in rows)
    assert all(us > 0 and n >= 1 for _, n, us in rows)
    assert [r[2] for r in rows] == sorted((r[2] for r in rows), reverse=True)


def test_deterministic_cudnn_is_scoped_to_the_block():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    with pytest.raises(RuntimeError, match="inside"):
        with deterministic_cudnn():
            assert cudnn.deterministic and not cudnn.benchmark
            raise RuntimeError("inside")
    assert (cudnn.deterministic, cudnn.benchmark) == before


TINY_XCONFIG = """
input name=ivector dim=100
input name=input dim=40
idct-layer name=idct input=input dim=40 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
linear-component name=ivector-linear l2-regularize=0.03 dim=40 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-batchnorm, ivector-batchnorm) num-filters1=1 num-filters2=1 height=40
conv-relu-batchnorm-layer name=cnn1 height-in=40 height-out=20 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=2
tdnnf-layer name=tdnnf2 dim=32 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf3 big-dim=24 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=24 small-dim=12
output-layer name=output include-log-softmax=false dim=48
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=24 small-dim=12
output-layer name=output-xent dim=48
"""


def test_ng_precision_reruns_the_recorded_ng_calls(tmp_path):
    """The NG step's calls, recorded and re-run from the same inputs on the
    same device in the same dtype, give the same result (0 x the bars); a
    float64 re-run stays near it; the rank split marks the sites."""
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    from kaldi_fp16_tpu_torch.tools import ng_precision as ngp
    cpu = torch.device("cpu")
    xconfig = tmp_path / "tiny.xconfig"
    xconfig.write_text(TINY_XCONFIG)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_phone_lm_den_fst(48, 13, 2, 4, seed=3), 48), leaky=1e-5,
        device=cpu)
    rec = ngp.record_ng_step(cpu, den, batch=4, frames_in=48, frames_out=15,
                             xconfig=str(xconfig))
    assert bool(rec["out"].ok) and not bool(rec["out"].skipped)
    recorded = (ngp.cast(rec["new"], cpu), ngp.cast(rec["pre"], cpu))
    again = ngp.ng_calls(rec, cpu, torch.float32)
    same = ngp.ng_excess(again, recorded, rec["sites"], rec["grads"])
    assert set(same) == {s["name"] for s in rec["sites"]}
    assert max(same.values()) == 0.0
    ref = ngp.ng_calls(rec, cpu, torch.float64)
    assert ref[0]["output/w"]["out"].v.dtype == torch.float64
    near = ngp.ng_excess(recorded, ref, rec["sites"], rec["grads"])
    assert all(v < float("inf") for v in near.values())
    # every site of this narrow model keeps half a dimension or more on
    # one side; a 100-wide input with rank 20 alone is under half
    assert ngp.well_posed(rec["states"]) == []
    st = rec["states"]["ivector-linear/w"]["in"]
    assert 2 * st.v.shape[0] < st.v.shape[1] - 1


def test_ng_precision_needs_a_card():
    from kaldi_fp16_tpu_torch.tools import ng_precision
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ng_precision.main([])
