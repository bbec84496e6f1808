"""The segment_reduce of the PyTorch port against the JAX package's kernel.

`segment_reduce_plain` and `segment_reduce` on CPU tensors (where the
wrapper computes the plain version) get the same numpy inputs as the JAX
`blocked_segment_reduce` (exact mode, which runs interpreted off a TPU),
and all three are held against the float64 sum at rtol / atol 1e-5, the
bar of tests/test_pallas_reduce.py:30 (fp32 sums of up to K terms).  The
shapes are that file's: padding labels, all padding, and K larger than
the JAX kernel's k_block.

The CUDA kernel itself runs only on a card: the `gpu` test compares it
with the plain version there.  JAX is imported inside the tests that use
it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_segment_reduce.py`.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.ops.segment_reduce import (
    segment_reduce, segment_reduce_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _fp64(vals, labels, sb):
    NB, K, N = vals.shape
    out = np.zeros((NB, sb, N), np.float64)
    for b in range(NB):
        for k in range(K):
            s = labels[b, k]
            if 0 <= s < sb:
                out[b, s] += vals[b, k]
    return out


def _inputs(NB, K, N, seed=0, high=129):
    rng = np.random.default_rng(seed)
    vals = rng.random((NB, K, N)).astype(np.float32)
    labels = rng.integers(0, high, (NB, K)).astype(np.int32)  # 128 = pad
    return vals, labels


def _jax(vals, labels, **kw):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from kaldi_fp16_tpu.ops.pallas_reduce import blocked_segment_reduce
    return np.asarray(blocked_segment_reduce(
        jnp.asarray(vals), jnp.asarray(labels), sb=128, exact=True, **kw))


@pytest.mark.parametrize("NB,K,N", [(2, 256, 8), (3, 384, 130), (1, 128, 1)])
def test_matches_jax_and_fp64(NB, K, N):
    vals, labels = _inputs(NB, K, N)
    ref = _fp64(vals, labels, 128)
    v, lab = torch.from_numpy(vals), torch.from_numpy(labels)
    plain = segment_reduce_plain(v, lab, 128)
    wrapped = segment_reduce(v, lab, sb=128)
    assert plain.shape == (NB, 128, N) and plain.dtype == torch.float32
    assert torch.equal(plain, wrapped)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    np.testing.assert_allclose(_jax(vals, labels), ref, **TOL)
    np.testing.assert_allclose(plain.numpy(), _jax(vals, labels), **TOL)


def test_padding_labels_contribute_nothing():
    vals = np.full((1, 128, 8), 7.0, np.float32)
    for pad in (128, 1000, -1):
        labels = np.full((1, 128), pad, np.int32)
        out = segment_reduce(torch.from_numpy(vals), torch.from_numpy(labels))
        assert float(out.abs().max()) == 0.0
    np.testing.assert_array_equal(
        _jax(vals, np.full((1, 128), 128, np.int32)), 0.0)


def test_k_larger_than_the_jax_k_block():
    vals, labels = _inputs(1, 512, 8, seed=1, high=128)
    ref = _fp64(vals, labels, 128)
    out = segment_reduce(torch.from_numpy(vals), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(_jax(vals, labels, k_block=128), ref, **TOL)


def test_other_block_width_and_no_launch_on_cpu():
    vals, labels = _inputs(2, 200, 5, seed=2, high=40)
    before = segment_reduce.launches
    out = segment_reduce(torch.from_numpy(vals), torch.from_numpy(labels),
                         sb=32)
    assert segment_reduce.launches == before
    np.testing.assert_allclose(out.numpy(), _fp64(vals, labels, 32), **TOL)


def test_rejects_what_the_kernel_does_not_take():
    vals, labels = (torch.from_numpy(a) for a in _inputs(1, 16, 4))
    with pytest.raises(ValueError):                 # exact-only
        segment_reduce(vals, labels, exact=False)
    with pytest.raises(ValueError):
        segment_reduce(vals.double(), labels)
    with pytest.raises(ValueError):
        segment_reduce(vals, labels.long())
    with pytest.raises(ValueError):
        segment_reduce(vals, labels[:, :8])


@pytest.mark.gpu
@pytest.mark.parametrize("NB,K,N,sb", [
    (2, 256, 8, 128), (3, 384, 130, 128), (2, 300, 70, 200),
    pytest.param(25, 6144, 384, 128, id="production-pdf-order"),
])
def test_cuda_kernel_against_plain(NB, K, N, sb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the segment_reduce kernel is CUDA "
                    "only")
    vals, labels = _inputs(NB, K, N, seed=3, high=sb + 1)
    dev = torch.device("cuda")
    v, lab = torch.from_numpy(vals).to(dev), torch.from_numpy(labels).to(dev)
    before = segment_reduce.launches
    out = segment_reduce(v, lab, sb=sb)
    again = segment_reduce(v, lab, sb=sb)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 2
    assert torch.equal(out, again)               # no atomics: fixed order
    torch.testing.assert_close(out, segment_reduce_plain(v, lab, sb), **TOL)
    if NB * K <= 2048:
        np.testing.assert_allclose(out.cpu().numpy(),
                                   _fp64(vals, labels, sb), **TOL)
