"""The den matmul of the PyTorch port against the JAX package's Pallas kernels.

`den_matmul_plain` (what `DenMatmul.apply` computes for a CPU tensor),
`den_matmul_split_plain` (the kernels' 3-term bf16 split arithmetic in
plain PyTorch), `PallasDenMatmul` and the probe's `make_mpre` /
`make_msplit` (_probe_pallas_den.py; all run in Pallas interpret mode, as
tests/test_pallas_den_matmul.py runs the package's kernel) get the same
numpy inputs, and each is held against the float64 product:

  * FP64_RTOL = 3e-6 relative for fp32 and for terms=6: the fp32-class bar
    of tests/test_pallas_den_matmul.py:46-48;
  * TERMS3_RTOL = 3e-5 relative for terms=3, which drops the m2, v2 terms
    (bf16x3, XLA HIGH's class: a few 2^-17 per element);
  * SAME_RTOL = 2e-6 between the split plain version and the Pallas
    kernels: the same products, summed in another order.

The CUDA kernels themselves run only on a card: the `gpu` test compares
them with the plain versions there.  JAX is imported inside the tests that
use it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_den_matmul.py`.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.ops.den_matmul import (
    DenMatmul, den_matmul_plain, den_matmul_split_plain,
)

FP64_RTOL = 3e-6    # fp32-class accuracy, tests/test_pallas_den_matmul.py:46-48
TERMS3_RTOL = 3e-5  # bf16x3 (m2, v2 dropped)
SAME_RTOL = 2e-6    # the same split products in another summation order
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every pallas_call of the JAX kernel in interpreter mode."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    import kaldi_fp16_tpu.ops.pallas_den_matmul as mod
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod.PallasDenMatmul


@pytest.fixture
def probe_interpret(monkeypatch):
    """The probe script _probe_pallas_den.py with its pallas_calls in
    interpreter mode."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        "_probe_pallas_den", ROOT / "_probe_pallas_den.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


def _inputs(F, n, sparse=False, seed=0, vshape=None):
    rng = np.random.default_rng(seed)
    M = rng.random((F, F)).astype(np.float32)
    if sparse:
        M *= rng.random((F, F)) < 0.05
    v = rng.random((F,) + (vshape or (n,))).astype(np.float32)
    return M, v


def _max_rel(out, ref):
    out = np.asarray(out, np.float64).reshape(ref.shape)
    return float(np.max(np.abs(out - ref) / (np.abs(ref) + 1e-8)))


def _fp64(M, v, transpose):
    M64 = M.astype(np.float64)
    return (M64.T if transpose else M64) @ v.reshape(len(v), -1).astype(np.float64)


CASES = [
    pytest.param(256, 128, False, id="F256-n128"),
    pytest.param(300, 40, False, id="unaligned-F300-n40"),
    pytest.param(256, 128, True, id="sparse-F256-n128"),
]


@pytest.mark.parametrize("F,n,sparse", CASES)
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_and_pallas_against_fp64(pallas_interpret, F, n, sparse,
                                       transpose):
    import jax.numpy as jnp
    M, v = _inputs(F, n, sparse)
    ref = _fp64(M, v, transpose)
    port = DenMatmul(M, "cpu").apply(torch.from_numpy(v), transpose)
    jax_out = pallas_interpret(M, terms=6).apply(jnp.asarray(v), transpose)
    assert port.shape == v.shape and port.dtype == torch.float32
    assert _max_rel(port.numpy(), ref) < FP64_RTOL
    assert _max_rel(np.asarray(jax_out), ref) < FP64_RTOL


@pytest.mark.parametrize("terms", [3, 6])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("F,n,sparse", [
    pytest.param(200, 128, False, id="ragged-F200-n128"),
    pytest.param(300, 40, True, id="sparse-F300-n40"),
])
def test_split_plain_matches_pallas_den_matmul(pallas_interpret, F, n, sparse,
                                               transpose, terms):
    import jax.numpy as jnp
    M, v = _inputs(F, n, sparse, seed=4)
    ref = _fp64(M, v, transpose)
    port = den_matmul_split_plain(torch.from_numpy(M), torch.from_numpy(v),
                                  transpose, terms).numpy()
    jax_out = np.asarray(pallas_interpret(M, terms=terms)
                         .apply(jnp.asarray(v), transpose))
    bar = FP64_RTOL if terms == 6 else TERMS3_RTOL
    assert port.shape == v.shape
    assert _max_rel(port, ref) < bar
    assert _max_rel(jax_out, ref) < bar
    assert _max_rel(port, jax_out.astype(np.float64)) < SAME_RTOL


@pytest.mark.parametrize("maker", ["make_mpre", "make_msplit"])
@pytest.mark.parametrize("terms", [3, 6])
@pytest.mark.parametrize("transpose", [False, True])
def test_split_plain_matches_probe_kernels(probe_interpret, maker, terms,
                                           transpose):
    """The probe's two variants (M pre-split into bf16 planes, or split
    in-kernel) at a ragged F = 200, n = 128; M^T goes in as its own
    matrix, since the probe applies M only."""
    import jax.numpy as jnp
    M, v = _inputs(200, 128, seed=5)
    A = np.ascontiguousarray(M.T) if transpose else M
    ref = _fp64(M, v, transpose)
    probe = np.asarray(getattr(probe_interpret, maker)(A, terms, 64)(
        jnp.asarray(v)))
    port = den_matmul_split_plain(torch.from_numpy(M), torch.from_numpy(v),
                                  transpose, terms).numpy()
    bar = FP64_RTOL if terms == 6 else TERMS3_RTOL
    assert probe.shape == port.shape == v.shape
    assert _max_rel(probe, ref) < bar
    assert _max_rel(port, ref) < bar
    assert _max_rel(port, probe.astype(np.float64)) < SAME_RTOL


def test_multidim_v(pallas_interpret):
    import jax.numpy as jnp
    M, v = _inputs(256, 0, vshape=(2, 3), seed=1)
    ref = _fp64(M, v, False)
    port = DenMatmul(M, "cpu").apply(torch.from_numpy(v), False)
    split = den_matmul_split_plain(torch.from_numpy(M), torch.from_numpy(v),
                                   False)
    jax_out = pallas_interpret(M, terms=6).apply(jnp.asarray(v), False)
    assert port.shape == split.shape == (256, 2, 3)
    assert _max_rel(port.numpy(), ref) < FP64_RTOL
    assert _max_rel(split.numpy(), ref) < FP64_RTOL
    assert _max_rel(np.asarray(jax_out), ref) < FP64_RTOL


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    M, v = _inputs(64, 8, seed=2)
    Mt, vt = torch.from_numpy(M), torch.from_numpy(v)
    before = (DenMatmul.launches, DenMatmul.launches_pre)
    for split in ("kernel", "pre"):
        for transpose in (False, True):
            out = DenMatmul(M, "cpu", split=split).apply(vt, transpose)
            torch.testing.assert_close(out, den_matmul_plain(Mt, vt, transpose),
                                       rtol=0, atol=0)
    assert (DenMatmul.launches, DenMatmul.launches_pre) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dm = DenMatmul(np.eye(8, dtype=np.float32), "cpu")
    with pytest.raises(TypeError):
        dm.apply(torch.zeros(8, 2, dtype=torch.float64), False)
    with pytest.raises(ValueError):
        dm.apply(torch.zeros(7, 2), False)
    with pytest.raises(ValueError):
        DenMatmul(np.zeros((4, 5), np.float32), "cpu")
    with pytest.raises(ValueError):
        DenMatmul(np.eye(8, dtype=np.float32), "cpu", split="tf32")
    with pytest.raises(ValueError):
        DenMatmul(np.eye(8, dtype=np.float32), "cpu", terms=2)
    with pytest.raises(ValueError):
        den_matmul_split_plain(torch.eye(8), torch.ones(8, 2), False, terms=1)


@pytest.mark.gpu
@pytest.mark.parametrize("F,n,sparse", CASES + [
    pytest.param(3526, 128, True, id="bench-shape-F3526-n128"),
    pytest.param(3526, 3, True, id="sparse-F3526-n3"),
])
def test_cuda_kernel_against_plain(F, n, sparse):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the den_matmul kernel is CUDA only")
    M, v = _inputs(F, n, sparse, seed=3)
    dev = torch.device("cuda")
    vd = torch.from_numpy(v).to(dev)
    for split in ("kernel", "pre"):
        for terms in (3, 6):
            dm = DenMatmul(M, dev, split=split, terms=terms)
            for transpose in (False, True):
                before = (DenMatmul.launches, DenMatmul.launches_pre)
                out = dm.apply(vd, transpose)
                again = dm.apply(vd, transpose)
                torch.cuda.synchronize()
                pre = split == "pre"
                assert (DenMatmul.launches, DenMatmul.launches_pre) == (
                    before[0] + 2 * (not pre), before[1] + 2 * pre)
                # the K slices of a tile are summed in a fixed order
                assert torch.equal(out, again)
                ref = _fp64(M, v, transpose)
                plain = den_matmul_split_plain(dm.M, vd, transpose, terms)
                bar = FP64_RTOL if terms == 6 else TERMS3_RTOL
                assert _max_rel(out.cpu().numpy(), ref) < bar
                assert _max_rel(plain.cpu().numpy(), ref) < bar
    with pytest.raises(ValueError):      # not contiguous
        dm.apply(torch.empty(F, 2 * n, device=dev)[:, ::2], False)
