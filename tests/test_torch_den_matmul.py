"""The den matmul of the PyTorch port against the JAX package's Pallas kernel.

`den_matmul_plain` (what `DenMatmul.apply` computes for a CPU tensor) and
`PallasDenMatmul` (run in Pallas interpret mode, as
tests/test_pallas_den_matmul.py runs it) get the same numpy inputs, and
both are held against the float64 product at 3e-6 relative: the fp32-class
bar of tests/test_pallas_den_matmul.py:46-48.

The CUDA kernel itself runs only on a card: the `gpu` test compares it
with the plain version there.  JAX is imported inside the tests that use
it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_den_matmul.py`.
"""

import functools

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.ops.den_matmul import DenMatmul, den_matmul_plain

FP64_RTOL = 3e-6   # fp32-class accuracy, tests/test_pallas_den_matmul.py:46-48


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every pallas_call of the JAX kernel in interpreter mode."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    import kaldi_fp16_tpu.ops.pallas_den_matmul as mod
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod.PallasDenMatmul


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
    port = DenMatmul(M).apply(torch.from_numpy(v), transpose)
    jax_out = pallas_interpret(M, terms=6).apply(jnp.asarray(v), transpose)
    assert port.shape == v.shape and port.dtype == torch.float32
    assert _max_rel(port.numpy(), ref) < FP64_RTOL
    assert _max_rel(np.asarray(jax_out), ref) < FP64_RTOL


def test_multidim_v(pallas_interpret):
    import jax.numpy as jnp
    M, v = _inputs(256, 0, vshape=(2, 3), seed=1)
    ref = _fp64(M, v, False)
    port = DenMatmul(M).apply(torch.from_numpy(v), False)
    jax_out = pallas_interpret(M, terms=6).apply(jnp.asarray(v), False)
    assert port.shape == (256, 2, 3)
    assert _max_rel(port.numpy(), ref) < FP64_RTOL
    assert _max_rel(np.asarray(jax_out), ref) < FP64_RTOL


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    M, v = _inputs(64, 8, seed=2)
    Mt, vt = torch.from_numpy(M), torch.from_numpy(v)
    before = DenMatmul.launches
    for transpose in (False, True):
        out = DenMatmul(M).apply(vt, transpose)
        torch.testing.assert_close(out, den_matmul_plain(Mt, vt, transpose),
                                   rtol=0, atol=0)
    assert DenMatmul.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dm = DenMatmul(np.eye(8, dtype=np.float32))
    with pytest.raises(TypeError):
        dm.apply(torch.zeros(8, 2, dtype=torch.float64), False)
    with pytest.raises(ValueError):
        dm.apply(torch.zeros(7, 2), False)
    with pytest.raises(ValueError):
        DenMatmul(np.zeros((4, 5), np.float32))


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
    dm = DenMatmul(M, dev)
    vd = torch.from_numpy(v).to(dev)
    for transpose in (False, True):
        before = DenMatmul.launches
        out = dm.apply(vd, transpose)
        again = dm.apply(vd, transpose)
        torch.cuda.synchronize()
        assert DenMatmul.launches == before + 2
        # each output tile is summed by one block in a fixed order
        assert torch.equal(out, again)
        plain = den_matmul_plain(dm.M, vd, transpose)
        ref = _fp64(M, v, transpose)
        assert _max_rel(out.cpu().numpy(), ref) < FP64_RTOL
        assert _max_rel(plain.cpu().numpy(), ref) < FP64_RTOL
    with pytest.raises(ValueError):      # not contiguous
        dm.apply(torch.empty(F, 2 * n, device=dev)[:, ::2], False)
