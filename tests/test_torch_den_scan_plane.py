"""The fast den's one-plane route of the fused scans at terms = 1.

At terms = 1 the scans' product is one bf16 pass, m0 b0: M and the
operand rounded to bf16 (to nearest even) and their exact products summed
in fp32.  The one-plane route (ops/den_scan.py `ScanPlane`, csrc/den_mma.cuh
`plane_product_block`) reads M's plane m0 = bf16(M) and nothing else.
On the CPU these tests hold what the route is made of: bf16(M) is
`split3(M)[0]` bit for bit, the plain scans give the same bits from M or
from the plane, the wrappers refuse the plane where it does not apply,
the panel layout is the one the kernel indexes, and the fast den that
passes the plane computes what it computed without it.

On a card (the `gpu` test) the one-plane kernels equal the three-plane
terms = 1 kernels bit for bit, and lie within the plain versions' terms =
1 bars (chip_smoke.py HIST1_REL_TO_MAX):
`python -m pytest --noconftest -m gpu tests/test_torch_den_scan_plane.py`.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst,
)
from kaldi_fp16_tpu_torch.ops import den_scan
from kaldi_fp16_tpu_torch.ops.den_matmul import split3, split_planes
from kaldi_fp16_tpu_torch.ops.den_scan import ScanPlane, core_panels
from kaldi_fp16_tpu_torch.tools import ablate_den_scan

HIST_RTOL, HIST_ATOL_REL = 2e-5, 1e-7
HIST1_REL_TO_MAX = 2.0 ** -6        # chip_smoke.py: two bf16 ulps of the max
GRAPHS = {"L2": (24, 13, 2, 4, 3), "L3": (30, 8, 3, 3, 7)}


def _graph(key):
    P, phones, states, branching, seed = GRAPHS[key]
    return DenominatorGraph.from_fst(
        make_phone_lm_den_fst(P, phones, states, branching, seed=seed), P)


def _tables(key, T, seed):
    """A fused-ready (padded) den's kernels and hoisted emission tables."""
    g = _graph(key)
    sk = StructuredKernels(analyze_chain_structure(g), 1e-4,
                           scan_impl="fused", device="cpu")
    x = np.random.default_rng(seed).normal(
        size=(T, g.num_pdfs, 128)).astype(np.float32)
    return sk, sk._hoisted_emissions(torch.exp(torch.from_numpy(x)))


def _random_M(Fp, seed):
    """A phone-LM-like residual matrix: sparse, nonnegative, with values
    that are not bf16 numbers."""
    rng = np.random.default_rng(seed)
    M = rng.random((Fp, Fp)) * (rng.random((Fp, Fp)) < 0.05)
    return torch.from_numpy((M / 7.0).astype(np.float32))


@pytest.mark.parametrize("source", ["random", "den-L2", "den-L3"])
def test_plane_is_plane_0_of_split3(source):
    if source == "random":
        M = torch.from_numpy(np.random.default_rng(1).normal(
            size=(256, 256)).astype(np.float32))
    else:
        M = _tables(source[4:], 2, seed=0)[0].M      # padded: zero rows
    plane = M.to(torch.bfloat16)
    assert torch.equal(plane.view(torch.int16),
                       split3(M)[0].view(torch.int16))
    assert torch.equal(ScanPlane(plane).plane.view(torch.int16),
                       plane.view(torch.int16))


@pytest.mark.parametrize("key", ["L2", "L3"])
def test_plain_scans_take_the_plane_bit_for_bit(key):
    """The plain versions at terms = 1, and the CPU wrappers given a
    ScanPlane, give the same bits as from the fp32 M."""
    T, leaky = 5, 1e-4
    sk, (xs_self, xs_fwd, xs_res) = _tables(key, T, seed=2)
    L, M, init = sk.lay.L, sk.M, sk.init
    plane = ScanPlane(M.to(torch.bfloat16))
    kw = dict(L=L, T=T, leaky=leaky, terms=1)
    ref = den_scan.fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                       **kw)
    from_plane = den_scan.fused_forward_plain(plane.plane.t(), xs_self,
                                              xs_fwd, xs_res, init, **kw)
    before = (den_scan.fused_forward.launches_plane,
              den_scan.fused_backward.launches_plane)
    wrapped = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                     plane=plane, **kw)
    for a, b, c in zip(ref, from_plane, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)
    total = ref[3] * (1.0 + leaky * sk._init_sum)
    args = (xs_self, xs_fwd, xs_res, ref[1], init, sk.real, total)
    beta = den_scan.fused_backward_plain(M, *args, **kw)
    assert torch.equal(beta, den_scan.fused_backward_plain(plane.plane,
                                                           *args, **kw))
    assert torch.equal(beta, den_scan.fused_backward(M, *args, plane=plane,
                                                     **kw))
    assert (den_scan.fused_forward.launches_plane,
            den_scan.fused_backward.launches_plane) == before


def _refusals(M):
    Fp = M.shape[0]
    plane = ScanPlane(M.to(torch.bfloat16))
    return {
        "terms3": (dict(terms=3, plane=plane), "terms=3"),
        "terms6": (dict(terms=6, plane=plane), "terms=6"),
        "shape": (dict(terms=1, plane=ScanPlane(
            torch.zeros((Fp + 128, Fp + 128), dtype=torch.bfloat16))),
            f"({Fp + 128}, {Fp + 128})"),
        "tensor": (dict(terms=1, plane=plane.plane[None]), "ScanPlane"),
        "device": (dict(terms=1, plane=ScanPlane(
            torch.empty((Fp, Fp), dtype=torch.bfloat16, device="meta"))),
            "meta"),
        "with_planes": (dict(terms=1, plane=plane,
                             planes=torch.stack(split3(M))), "not both"),
    }


@pytest.mark.parametrize("case", ["terms3", "terms6", "shape", "tensor",
                                  "device", "with_planes"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_wrappers_refuse_the_plane_where_it_does_not_apply(case, direction):
    T = 3
    sk, (xs_self, xs_fwd, xs_res) = _tables("L2", T, seed=3)
    M = sk.M
    extra, says = _refusals(M)[case]
    kw = dict(L=sk.lay.L, T=T, leaky=1e-4, **extra)
    with pytest.raises(ValueError, match=says.replace("(", r"\(")
                       .replace(")", r"\)")):
        if direction == "fwd":
            den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, sk.init, **kw)
        else:
            den_scan.fused_backward(M, xs_self, xs_fwd, xs_res,
                                    torch.ones((T, 128)), sk.init, sk.real,
                                    torch.ones(128), **kw)


@pytest.mark.parametrize("plane", [
    torch.zeros((256, 256)),                                  # fp32
    torch.zeros((256, 256), dtype=torch.float16),
    torch.zeros((1, 256, 256), dtype=torch.bfloat16),         # not 2-D
    torch.zeros((256, 128), dtype=torch.bfloat16),            # not square
    torch.zeros((200, 200), dtype=torch.bfloat16),            # not tiled
], ids=["fp32", "fp16", "3d", "rect", "untiled"])
def test_scan_plane_refuses_other_dtypes_and_shapes(plane):
    with pytest.raises(ValueError, match="terms=1"):
        ScanPlane(plane)


def test_core_panels_is_the_kernels_layout():
    """X[r, k] at [r / 128][k / 8][r % 128 / 8][r % 8][k % 8]: the index
    den_mma.cuh's store_plane8 writes B at and plane_product_block reads A
    at."""
    R, K = 256, 48
    X = torch.arange(R * K, dtype=torch.float32).reshape(R, K)
    P = core_panels(X)
    assert P.shape == (R // 128, K // 8, 16, 8, 8) and P.is_contiguous()
    flat = P.reshape(-1)
    r, k = np.meshgrid(np.arange(R), np.arange(K), indexing="ij")
    at = (((r // 128 * (K // 8) + k // 8) * 16 + r % 128 // 8) * 64
          + r % 8 * 8 + k % 8)
    assert torch.equal(flat[torch.from_numpy(at.reshape(-1))], X.reshape(-1))


@pytest.mark.parametrize("key", ["L2", "L3"])
def test_fast_den_with_the_plane_computes_what_it_did(key, monkeypatch):
    """The fast den hands its ScanPlane to both scans (on a card it makes
    one; here one is forced in) and gets the same bits as without it; on
    the CPU it makes none."""
    g = _graph(key)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(128, 5, g.num_pdfs)).astype(np.float32))
    den = DenominatorComputation(g, leaky=1e-4, mode="fast",
                                 scan_impl="fused", device="cpu")
    sk = den._structured
    assert sk._plane is None and sk._planes is None
    lp, post = den.forward_backward(x)
    seen = []

    def spy(wrapped):
        def call(*args, **kw):
            seen.append(kw["plane"])
            return wrapped(*args, **kw)
        return call

    from kaldi_fp16_tpu_torch.chain import den_structured
    for name in ("fused_forward", "fused_backward"):
        monkeypatch.setattr(den_structured, name,
                            spy(getattr(den_structured, name)))
    sk._plane = ScanPlane(sk._M_bf16)
    lp_p, post_p = den.forward_backward(x)
    assert sk.scan_used == "fused" and seen == [sk._plane, sk._plane]
    assert torch.equal(lp, lp_p) and torch.equal(post, post_p)


def test_exact_den_keeps_its_routes():
    """mode="exact" never takes the one plane; split="pre" keeps its three
    planes for the fused scans (made on a card only)."""
    for split in ("kernel", "pre"):
        sk = StructuredKernels(analyze_chain_structure(_graph("L2")), 1e-4,
                               scan_impl="fused", split=split, device="cpu")
        assert sk._plane is None and sk._planes is None


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 7])
def test_cuda_plane_scans_equal_the_three_plane_scans(T):
    """At Fp = 256, N = 128: the one-plane scans equal the three-plane
    terms = 1 scans (the fp32 M and split="pre"'s planes) bit for bit,
    repeats too, and lie within the plain versions' terms = 1 bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the den_scan kernels are CUDA only")
    dev = torch.device("cuda")
    Fp, L, N, leaky = 256, 2, 128, 1e-4
    rng = np.random.default_rng(5)
    M = _random_M(Fp, 4).to(dev)
    # unnormalised (its sum ~256), so that logc is ~5.5 and its bar, a share
    # of its largest entry, is not 0 at T = 1
    init = torch.from_numpy(rng.random((L, Fp)).astype(np.float32)).to(dev)
    real = torch.ones((L, Fp), dtype=torch.bool, device=dev)
    xs_self, xs_fwd, xs_res = (torch.from_numpy(
        rng.random(shape).astype(np.float32) + 0.5).to(dev)
        for shape in ((T, L, Fp, N), (T, L - 1, Fp, N), (T, Fp, N)))
    kw = dict(L=L, T=T, leaky=leaky, terms=1)
    plane = ScanPlane(M.to(torch.bfloat16))
    before = (den_scan.fused_forward.launches_plane,
              den_scan.fused_backward.launches_plane)
    out = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                 plane=plane, **kw)
    again = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                   plane=plane, **kw)
    ref = den_scan.fused_forward_plain(M.t(), xs_self, xs_fwd, xs_res, init,
                                       **kw)
    total = out[3] * (1.0 + leaky * float(init.sum()))
    args = (xs_self, xs_fwd, xs_res, out[1], init, real, total)
    beta = den_scan.fused_backward(M, *args, plane=plane, **kw)
    beta_again = den_scan.fused_backward(M, *args, plane=plane, **kw)
    beta_ref = den_scan.fused_backward_plain(M, *args, **kw)
    torch.cuda.synchronize()
    assert (den_scan.fused_forward.launches_plane,
            den_scan.fused_backward.launches_plane) == (before[0] + 2,
                                                        before[1] + 2)
    assert torch.equal(beta, beta_again)
    for planes in (None, split_planes(M, Fp)):
        std = den_scan.fused_forward(M, xs_self, xs_fwd, xs_res, init,
                                     planes=planes, **kw)
        std_beta = den_scan.fused_backward(M, *args, planes=planes, **kw)
        torch.cuda.synchronize()
        for a, b, s in zip(out, again, std):
            assert torch.equal(a, b) and torch.equal(a, s)
        assert torch.equal(beta, std_beta)

    def close(a, r, first):
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= HIST1_REL_TO_MAX * scale
        if a.ndim == 4:
            torch.testing.assert_close(a[first], r[first], rtol=HIST_RTOL,
                                       atol=HIST_ATOL_REL * scale)

    for a, r in zip(out, ref):
        close(a, r, slice(0, 2))
    close(beta, beta_ref, slice(-2, None))     # beta runs from T - 1 down


@pytest.mark.parametrize("name", sorted(ablate_den_scan.VARIANTS))
def test_ablation_variants_still_cut_the_sources(name):
    """tools.ablate_den_scan changes the sources by text: each variant
    still finds what it changes (else its chip run would time something
    else), and only base leaves them as they are."""
    from kaldi_fp16_tpu_torch.ops import _build
    texts = ablate_den_scan.variant_sources(name)
    same = all(texts[f] == (_build.CSRC / f).read_text() for f in texts)
    assert same == (name == "base")
