"""The reduction of a profiler trace to busy time, kernels and gaps."""

import pytest

from benchmark.harness.trace import kernel_base, summarize


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_kernel_names():
    assert kernel_base("void (anonymous namespace)::fwd_init_kernel"
                       "(float const*, int)") == "fwd_init_kernel"
    assert kernel_base("void at::native::elementwise_kernel<128, 2>(int)") \
        == "at::native::elementwise_kernel"
    assert kernel_base("sm90_xmma_gemm") == "sm90_xmma_gemm"


def test_busy_union_and_gaps():
    events = [
        ev("kernel", "void a_kernel<1>(int)", 0, 10),
        ev("kernel", "void a_kernel<1>(int)", 5, 10),      # overlaps
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 40, 5),
        ev("kernel", "b_kernel(float*)", 100, 20),
        ev("cpu_op", "aten::item", 50, 40),
        ev("cpu_op", "aten::mm", 10, 5),
        ev("user_annotation", "step", 0, 200),
    ]
    s = summarize(events, 1e-3)
    assert s["busy_s"] == pytest.approx((15 + 5 + 20) * 1e-6)
    assert s["kernels"]["a_kernel"] == {"seconds": pytest.approx(20e-6),
                                        "launches": 2}
    gaps = s["breakdown"]["idle_gaps"]
    # the longest gap (45..100) is inside aten::item, inside "step"
    assert gaps[0][0].startswith("aten::item")
    assert gaps[0][1] == pytest.approx(55e-6)
    assert gaps[1][1] == pytest.approx(25e-6)
    ops = s["breakdown"]["device_ops"]
    assert ops[0][0] == "a_kernel" and len(ops) == 3


def test_no_device_events():
    s = summarize([ev("cpu_op", "aten::mm", 0, 5)], 0.5)
    assert s["busy_s"] == 0 and s["breakdown"]["idle_gaps"] == []
