"""The segment_reduce of the PyTorch port against the JAX package's kernel.

`segment_reduce_plain` and `segment_reduce` on CPU tensors (where the
wrapper computes the plain version) get the same numpy inputs as the JAX
`blocked_segment_reduce` (exact mode, which runs interpreted off a TPU),
and all three are held against the float64 sum at rtol / atol 1e-5, the
bar of tests/test_pallas_reduce.py:30 (fp32 sums of up to K terms).  The
shapes are that file's: padding labels, all padding, and K larger than
the JAX kernel's k_block.

The label layouts the kernel must take whatever their order: sorted with
trailing padding (the blocked den's), shuffled, one label everywhere,
empty segments and negative padding, at ragged widths.
`segment_order_plain` (the kernel's order pass in plain PyTorch) is held
against numpy's stable argsort and bincount.

The CUDA kernel itself runs only on a card: the `gpu` tests compare it and
its order pass with the plain versions there, including the phone-LM
graph's real pdf-order labels at the production shape, and hold it equal
bit for bit to the plain version run on the CPU (both sum each segment
from zero in increasing k, without atomics).  JAX is imported inside the
tests that use it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_segment_reduce.py`.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.ops.segment_reduce import (
    segment_order, segment_order_plain, segment_reduce, segment_reduce_plain,
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


LAYOUTS = ["sorted-padding-last", "shuffled", "one-label", "empty-segments",
           "negative-padding"]


def _labels(layout, NB, K, sb, seed=0):
    """[NB, K] int32 labels of one layout; padding is sb (or < 0)."""
    rng = np.random.default_rng(seed)
    out = np.full((NB, K), sb, np.int32)
    for b in range(NB):
        if layout in ("sorted-padding-last", "shuffled"):
            # the blocked den's: a run per label, padding at the end
            counts = rng.integers(0, 3, sb)
            lab = np.repeat(np.arange(sb, dtype=np.int32), counts)[:K]
            out[b, :len(lab)] = lab
            if layout == "shuffled":
                out[b] = out[b, rng.permutation(K)]
        elif layout == "one-label":
            out[b] = sb // 3
        elif layout == "empty-segments":
            # odd labels only, and padding
            out[b] = rng.integers(0, sb // 2 + 1, K) * 2 + 1
            out[b, out[b] > sb] = sb
        else:                                   # negative-padding
            out[b] = rng.integers(-3, sb + 3, K)
    return out


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


@pytest.mark.parametrize("N", [1, 3, 5, 130])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_label_layouts_match_jax_and_fp64(layout, N):
    NB, K = 2, 256
    vals = np.random.default_rng(N).random((NB, K, N)).astype(np.float32)
    labels = _labels(layout, NB, K, 128, seed=N)
    ref = _fp64(vals, labels, 128)
    out = segment_reduce(torch.from_numpy(vals), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(_jax(vals, labels), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), _jax(vals, labels), **TOL)


@pytest.mark.parametrize("sb", [128, 32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_order_plain_is_a_stable_counting_sort(layout, sb):
    NB, K = 3, 300
    labels = _labels(layout, NB, K, sb, seed=sb)
    order, offsets = segment_order_plain(torch.from_numpy(labels), sb)
    assert order.dtype == offsets.dtype == torch.int32
    assert order.shape == (NB, K) and offsets.shape == (NB, sb + 1)
    for b in range(NB):
        lab = labels[b]
        valid = (lab >= 0) & (lab < sb)
        key = np.where(valid, lab, sb)
        np.testing.assert_array_equal(order[b].numpy(),
                                      np.argsort(key, kind="stable"))
        counts = np.bincount(lab[valid], minlength=sb)
        np.testing.assert_array_equal(
            offsets[b].numpy(), np.concatenate([[0], np.cumsum(counts)]))
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = segment_order.launches
    again = segment_order(torch.from_numpy(labels), sb)
    assert segment_order.launches == before
    assert torch.equal(again[0], order) and torch.equal(again[1], offsets)


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
    with pytest.raises(ValueError):
        segment_order(labels.long())
    with pytest.raises(ValueError):
        segment_order(labels[0])


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
    # summed from zero in increasing k, as index_add_ does on the CPU
    assert torch.equal(out.cpu(), segment_reduce_plain(
        torch.from_numpy(vals), torch.from_numpy(labels), sb))
    if NB * K <= 2048:
        np.testing.assert_allclose(out.cpu().numpy(),
                                   _fp64(vals, labels, sb), **TOL)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the segment_reduce kernel is CUDA "
                    "only")
    return torch.device("cuda")


def _check_on_card(vals, labels, sb):
    """The kernel on the card: repeats bit-identical, equal bit for bit to
    the plain version on the CPU, within TOL of the plain version on the
    card; its order pass equal to the plain one on the labelled prefix."""
    dev = _card()
    v, lab = vals.to(dev), labels.to(dev)
    before = segment_reduce.launches
    out = segment_reduce(v, lab, sb=sb)
    again = segment_reduce(v, lab, sb=sb)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), segment_reduce_plain(vals.cpu(),
                                                       labels.cpu(), sb))
    torch.testing.assert_close(out, segment_reduce_plain(v, lab, sb), **TOL)
    order, offsets = segment_order(lab, sb)
    order_ref, offsets_ref = segment_order_plain(labels.cpu(), sb)
    assert torch.equal(offsets.cpu(), offsets_ref)
    for b in range(labels.shape[0]):
        used = int(offsets_ref[b, -1])
        assert torch.equal(order[b, :used].cpu(), order_ref[b, :used])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 5, 130, 385])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_kernel_label_layouts_and_ragged_n(layout, N):
    NB, K = 3, 1000
    labels = torch.from_numpy(_labels(layout, NB, K, 128, seed=N))
    vals = torch.from_numpy(np.random.default_rng(N).random(
        (NB, K, N)).astype(np.float32))
    out = _check_on_card(vals, labels, 128)
    np.testing.assert_allclose(out.cpu().numpy(),
                               _fp64(vals.numpy(), labels.numpy(), 128),
                               **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8, 130])
def test_cuda_kernel_misaligned_base(N):
    """vals starting 4 bytes past an aligned address take the scalar
    loads."""
    NB, K = 2, 300
    buf = torch.from_numpy(np.random.default_rng(7).random(
        NB * K * N + 1).astype(np.float32))
    vals = buf[1:].view(NB, K, N)
    assert vals.is_contiguous()
    labels = torch.from_numpy(_labels("shuffled", NB, K, 128, seed=7))
    dev = _card()
    vd = buf.to(dev)[1:].view(NB, K, N)
    out = segment_reduce(vd, labels.to(dev))
    assert torch.equal(out.cpu(), segment_reduce_plain(vals, labels))


@pytest.mark.gpu
def test_cuda_kernel_on_the_phone_lm_pdf_order():
    """The blocked den's real labels: the phone-LM graph's pdf order at the
    production shape [25, 6144, 3 * 128]."""
    from kaldi_fp16_tpu_torch.chain.denominator import _BlockedOrder
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=3080),
                                      3080)
    pdfo = _BlockedOrder(graph.pdf, 3080, graph, graph.src, device="cpu")
    labels = pdfo.local
    assert tuple(labels.shape) == (25, 6144)
    vals = torch.from_numpy(np.random.default_rng(8).random(
        (25, 6144, 384)).astype(np.float32))
    _check_on_card(vals, labels, 128)
