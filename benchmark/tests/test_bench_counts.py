"""The shape counts against sums worked by hand at small shapes."""

import pytest

from benchmark.counts.den_scan import den_flops, scan_work
from benchmark.counts.network import step_flops
from benchmark.counts.peaks import H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BYTES
from benchmark.reference.model import build_model_from_string

TWO_LAYERS = """\
input name=input dim=4
relu-batchnorm-layer name=r1 dim=6
output-layer name=output include-log-softmax=false dim=3
"""

CONV = """\
input name=input dim=8
conv-relu-batchnorm-layer name=c1 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=2
output-layer name=output include-log-softmax=false dim=3
"""


def test_dense_layers_by_hand():
    m = build_model_from_string(TWO_LAYERS)
    B, T = 2, 5
    rows = B * T        # stride 1: every layer at the input rate
    r1 = 2 * rows * 4 * 6
    out = 2 * rows * 6 * 3
    # r1: forward + weight grad (its input, the features, has no grad);
    # output: forward + weight grad + input grad
    assert step_flops(m, B, T, 1) == pytest.approx(2 * r1 + 3 * out)


def test_conv_layer_by_hand():
    m = build_model_from_string(CONV)
    B, T = 1, 4
    k = 3 * 3 * 1           # time x height offsets x filters in
    conv = 2 * B * T * 4 * k * 2    # 4 output heights, 2 filters out
    out = 2 * B * T * (4 * 2) * 3
    assert step_flops(m, B, T, 1) == pytest.approx(2 * conv + 3 * out)


def test_grid_rows():
    m = build_model_from_string(TWO_LAYERS)
    # stride 3: both layers are pointwise and feed the output: grid rows
    B, T = 2, 10
    n_grid = (T - 3) // 3 + 1
    rows = B * n_grid
    assert step_flops(m, B, T, 3) == pytest.approx(
        2 * (2 * rows * 4 * 6) + 3 * (2 * rows * 6 * 3))


def test_den_scan_by_hand():
    F, L, N, T = 3, 2, 4, 5
    w = scan_work(F, L, N, T)
    assert w["flops"] == T * (2 * F * F * N + 4 * L * F * N)
    assert w["bytes"] == (F * F * 4 + T * 2 * L * F * N * 4
                          + T * L * F * N * 4 + T * N * 2 * 4)
    assert w["bound_s"] == max(w["flops"] / H100_PEAK_BF16_FLOPS,
                               w["bytes"] / H100_PEAK_HBM_BYTES)
    assert den_flops(F, L, N, T, 6, 7) == 2 * w["flops"] + T * N * (12 + 7)


def test_production_den_is_bytes_bound():
    w = scan_work(3526, 2, 128, 49)
    assert w["bound_by"] == "bytes"
    assert 0.15e-3 < w["bound_s"] < 0.2e-3
