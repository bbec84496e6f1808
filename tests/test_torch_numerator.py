"""The PyTorch port's numerator forward-backward against the JAX package.

Same numpy inputs through `kaldi_fp16_tpu.chain.numerator` (the jitted
lax.scan with one-hot matmuls) and `kaldi_fp16_tpu_torch.chain.numerator`,
and through the float64 oracle `numerator_forward_backward_ref`.  Both are
fp32 log-domain recursions; they differ in the order of the per-state sums
only, so log-probs agree to rtol 1e-5 and posteriors to 1e-4 / atol 1e-6
(the JAX package's own oracle bars in tests/test_chain_numerator.py are
of that class).  On CPU tensors the port computes its plain version and
launches nothing; the wrapper refuses what the CUDA kernel does not take.

The CUDA kernel (csrc/numerator.cu) runs only on a card: the `gpu` tests
hold it against the plain version on the card at the same bars, bit-equal
across repeats, one launch a call.  JAX is imported inside the tests that
use it, so this file also runs on a machine without JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_numerator.py`.
"""

import numpy as np
import pytest
import torch

from kaldi_fp16_tpu_torch.chain import graph as port_graph
from kaldi_fp16_tpu_torch.chain.graph import LOG_ZERO
from kaldi_fp16_tpu_torch.chain.numerator import (
    _forward_backward, numerator_forward_backward,
)
from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu_torch.io.sparse import fst_to_csr
from kaldi_fp16_tpu_torch.ops.den_matmul import fp32_matmuls
from kaldi_fp16_tpu_torch.ops.numerator import MAX_ARCS, MAX_STATES

LOGP_RTOL = 1e-5
POST_RTOL, POST_ATOL = 1e-4, 1e-6
P = 7
FIELDS = ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask", "start",
          "final_logw")


def random_fst(rng, num_states=6, num_pdfs=5, arcs_per_state=2, T=4):
    """tests/test_chain_numerator.py's `random_fst` on the port's Fst
    classes (the same draws from rng give the same FST): every state
    reaches a final state in exactly T steps."""
    layers = T + 1
    per = max(1, num_states // layers)
    ids = [[l * per + i for i in range(per)] for l in range(layers)]
    states = [FstState() for _ in range(per * layers)]
    for l in range(layers - 1):
        for sid in ids[l]:
            for _ in range(arcs_per_state):
                states[sid].arcs.append(FstArc(
                    int(rng.integers(1, num_pdfs + 1)),
                    float(rng.uniform(0, 1.5)),
                    int(rng.choice(ids[l + 1]))))
    for sid in ids[-1]:
        states[sid].final = float(rng.uniform(0, 1))
    return Fst(start=0, states=states)


def _fsts(rng, T):
    fsts = [random_fst(rng, num_states=3 * (T + 1), num_pdfs=P, T=T)
            for _ in range(2)]
    # an arc whose label is beyond num_pdfs (malformed graph): skipped
    bad = random_fst(rng, num_states=2 * (T + 1), num_pdfs=P, T=T)
    bad.states[0].arcs.append(FstArc(P + 3, 0.2, bad.states[0].arcs[0]
                                     .next_state))
    fsts.append(bad)
    # an unreachable final state: total LOG_ZERO, posteriors zeroed
    dead = [FstState() for _ in range(3)]
    dead[0].arcs = [FstArc(1, 0.1, 1)]
    dead[1].arcs = [FstArc(2, 0.3, 1)]
    dead[2].final = 0.0
    fsts.append(Fst(start=0, states=dead))
    return fsts


def _batch(fsts):
    """(csrs, JAX batch, port batch) of the same FSTs, arrays equal."""
    from kaldi_fp16_tpu.chain.graph import build_numerator_batch
    csrs = [fst_to_csr(f) for f in fsts]
    jb = build_numerator_batch(csrs)
    pb = port_graph.build_numerator_batch(csrs)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(jb, name), getattr(pb, name))
    return csrs, jb, pb


def test_random_fst_is_the_jax_tests_own():
    """The copy above draws the FSTs of tests/test_chain_numerator.py."""
    from kaldi_fp16_tpu.io.sparse import fst_to_csr as jax_fst_to_csr
    from tests.test_chain_numerator import random_fst as jax_random_fst
    for T in (4, 6):
        for kw in (dict(num_states=3 * (T + 1)), dict(num_states=2 * (T + 1))):
            ours = fst_to_csr(random_fst(np.random.default_rng(T), num_pdfs=P,
                                         T=T, **kw))
            theirs = jax_fst_to_csr(jax_random_fst(
                np.random.default_rng(T), num_pdfs=P, T=T, **kw))
            for name in ("row_ptr", "col_idx", "labels", "weights",
                         "final_states", "final_weights"):
                np.testing.assert_array_equal(getattr(ours, name),
                                              getattr(theirs, name))
            assert ours.start_state == theirs.start_state


@pytest.mark.parametrize("T", [4, 6])
def test_numerator_matches_jax_and_fp64(T):
    import jax.numpy as jnp
    from kaldi_fp16_tpu.chain.numerator import (
        numerator_forward_backward as jax_num,
    )
    from kaldi_fp16_tpu.chain.reference import numerator_forward_backward_ref
    rng = np.random.default_rng(T)
    csrs, jb, pb = _batch(_fsts(rng, T))
    x = rng.normal(size=(len(csrs), T, P)).astype(np.float32)
    before = numerator_forward_backward.launches
    lp, post = numerator_forward_backward(pb, torch.from_numpy(x))
    assert numerator_forward_backward.launches == before
    lp, post = lp.numpy(), post.numpy()
    jlp, jpost = jax_num(jb, jnp.asarray(x))
    np.testing.assert_allclose(lp, np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post, np.asarray(jpost), rtol=POST_RTOL,
                               atol=POST_ATOL)
    for b, csr in enumerate(csrs):
        rlp, rpost = numerator_forward_backward_ref(csr, x[b])
        if rlp <= LOG_ZERO:
            assert lp[b] == LOG_ZERO
            assert not post[b].any()
        else:
            np.testing.assert_allclose(lp[b], rlp, rtol=LOGP_RTOL)
            np.testing.assert_allclose(post[b], rpost, rtol=POST_RTOL,
                                       atol=POST_ATOL)
    assert lp[-1] == LOG_ZERO          # the unreachable final


def _linear(B, T, P, seed=0):
    """The benchmark's linear supervision: T + 1 states, each frame's arc
    and one parallel arc of another pdf (A = 2T)."""
    rng = np.random.default_rng(seed)
    A = 2 * T
    Sn = T + 1
    return dict(
        arc_src=np.tile(np.arange(A, dtype=np.int32) % T, (B, 1)),
        arc_dst=np.tile(np.arange(A, dtype=np.int32) % T + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, A)).astype(np.int32),
        arc_logw=np.zeros((B, A), np.float32),
        arc_mask=np.ones((B, A), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=A)


def test_bench_shaped_supervision():
    """bench.py's linear supervision (every arc consumes one frame, with
    parallel alternative-pdf arcs): finite total, one unit of posterior mass
    per frame, equal to JAX."""
    import jax.numpy as jnp
    from kaldi_fp16_tpu.chain.graph import NumeratorGraphBatch as JaxBatch
    from kaldi_fp16_tpu.chain.numerator import (
        numerator_forward_backward as jax_num,
    )
    rng = np.random.default_rng(0)
    B, T, An = 3, 5, 12
    Sn = T + 1
    kw = dict(
        arc_src=np.tile(np.arange(An, dtype=np.int32) % T, (B, 1)),
        arc_dst=np.tile(np.arange(An, dtype=np.int32) % T + 1, (B, 1)),
        arc_pdf=rng.integers(0, P, size=(B, An)).astype(np.int32),
        arc_logw=np.zeros((B, An), np.float32),
        arc_mask=np.ones((B, An), np.float32),
        start=np.zeros(B, np.int32),
        final_logw=np.where(np.arange(Sn)[None, :] == Sn - 1, 0.0,
                            LOG_ZERO).astype(np.float32).repeat(B, 0),
        num_states=Sn, num_arcs=An)
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    lp, post = numerator_forward_backward(port_graph.NumeratorGraphBatch(**kw),
                                          torch.from_numpy(x))
    jlp, jpost = jax_num(JaxBatch(**kw), jnp.asarray(x))
    assert np.all(lp.numpy() > -1e20)
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=LOGP_RTOL)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost),
                               rtol=POST_RTOL, atol=POST_ATOL)


def _graph(**kw):
    return port_graph.NumeratorGraphBatch(**kw)


def _small():
    kw = _linear(2, 4, P)
    return kw, torch.zeros((2, 4, P))


def _with(kw, **changes):
    out = dict(kw)
    out.update(changes)
    return out


REJECTS = {
    "float-index-array": lambda kw, x: (
        _with(kw, arc_src=kw["arc_src"].astype(np.float32)), x),
    "int-weight-array": lambda kw, x: (
        _with(kw, arc_logw=kw["arc_logw"].astype(np.int32)), x),
    "int-nnet-output": lambda kw, x: (kw, x.to(torch.int32)),
    "nnet-output-rank": lambda kw, x: (kw, x[0]),
    "arc-array-rank": lambda kw, x: (_with(kw, arc_dst=kw["arc_dst"][0]), x),
    "batch-vs-nnet-output": lambda kw, x: (kw, torch.zeros((3,) + x.shape[1:])),
    "batch-of-start": lambda kw, x: (_with(kw, start=kw["start"][:1]), x),
    "arc-width": lambda kw, x: (_with(kw, arc_pdf=kw["arc_pdf"][:, :-1]), x),
    "final-width-vs-states": lambda kw, x: (
        _with(kw, num_states=kw["num_states"] + 1), x),
    "states-past-the-limit": lambda kw, x: (
        _with(kw, num_states=MAX_STATES + 1, final_logw=np.full(
            (2, MAX_STATES + 1), LOG_ZERO, np.float32)), x),
    "arcs-past-the-limit": lambda kw, x: (
        {**kw, **{n: np.zeros((2, MAX_ARCS + 1), kw[n].dtype)
                  for n in ("arc_src", "arc_dst", "arc_pdf", "arc_logw",
                            "arc_mask")}, "num_arcs": MAX_ARCS + 1}, x),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_rejects_what_the_kernel_does_not_take(case):
    """The wrapper's checks, on CPU tensors too: they run before either
    route, so the CPU path refuses what the card's would."""
    kw, x = REJECTS[case](*_small())
    before = numerator_forward_backward.launches
    with pytest.raises(ValueError):
        numerator_forward_backward(_graph(**kw), x)
    assert numerator_forward_backward.launches == before


def test_cpu_call_launches_nothing_and_equals_the_plain_version():
    kw, _ = _small()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 4, P)).astype(np.float32))
    before = numerator_forward_backward.launches
    lp, post = numerator_forward_backward(_graph(**kw), x)
    assert numerator_forward_backward.launches == before
    rlp, rpost = _forward_backward(_graph(**kw), x)
    assert torch.equal(lp, rlp) and torch.equal(post, rpost)
    # int64 index arrays and tensors take the same route to the same bits
    wide = {n: (torch.from_numpy(v.astype(np.int64)) if v.dtype == np.int32
                else v) for n, v in kw.items() if n in FIELDS}
    lp64, post64 = numerator_forward_backward(
        _graph(**wide, num_states=kw["num_states"], num_arcs=kw["num_arcs"]),
        x)
    assert torch.equal(lp64, lp) and torch.equal(post64, post)
    assert numerator_forward_backward.launches == before


# --- the CUDA kernel, on a card -------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the numerator kernel is CUDA only")
    return torch.device("cuda")


def _layered(B, S, A, T, P, seed):
    """Random layered graphs of exactly S states and A arcs: T + 1 layers,
    a spine start -> ... -> a final state in T steps, the other arcs
    between random states of neighbouring layers (some unreachable or
    dead-ended), every state of the last layer final."""
    rng = np.random.default_rng(seed)
    per = S // (T + 1)
    layer = np.minimum(np.arange(S) // per, T)
    kw = {n: [] for n in FIELDS}
    for _ in range(B):
        l = rng.integers(0, T, size=A)
        l[:T] = np.arange(T)
        src = l * per + rng.integers(0, per, size=A)
        dst = (l + 1) * per + rng.integers(0, per, size=A)
        src[:T], dst[:T] = np.arange(T) * per, np.arange(1, T + 1) * per
        perm = rng.permutation(A)
        kw["arc_src"].append(src[perm])
        kw["arc_dst"].append(np.minimum(dst[perm], S - 1))
        kw["arc_pdf"].append(rng.integers(0, P, size=A))
        kw["arc_logw"].append(-rng.uniform(0, 2, size=A))
        kw["arc_mask"].append(np.ones(A))
        kw["start"].append(0)
        kw["final_logw"].append(np.where(layer == T, -rng.uniform(0, 1, S),
                                         LOG_ZERO))
    out = {n: np.asarray(v, np.int32 if n in ("arc_src", "arc_dst",
                                               "arc_pdf", "start")
                         else np.float32) for n, v in kw.items()}
    return dict(out, num_states=S, num_arcs=A)


def _padded(T, P, seed):
    """Graphs of 3, 7 and 12 frames padded to one batch: padding arcs
    (mask 0, src = dst = 0), and the shorter chains end before T (their
    later frames all dead, totals LOG_ZERO)."""
    rng = np.random.default_rng(seed)
    csrs = []
    for n in (3, 7, 12, T):
        states = [FstState() for _ in range(n + 1)]
        for i in range(n):
            for _ in range(2):
                states[i].arcs.append(FstArc(int(rng.integers(1, P + 1)),
                                             float(rng.uniform(0, 1)), i + 1))
        states[-1].final = 0.0
        csrs.append(fst_to_csr(Fst(start=0, states=states)))
    g = port_graph.build_numerator_batch(csrs)
    return {n: getattr(g, n) for n in FIELDS} | dict(
        num_states=g.num_states, num_arcs=g.num_arcs)


def _fst_batch(T):
    rng = np.random.default_rng(T)
    g = port_graph.build_numerator_batch([fst_to_csr(f)
                                          for f in _fsts(rng, T)])
    return {n: getattr(g, n) for n in FIELDS} | dict(
        num_states=g.num_states, num_arcs=g.num_arcs), P, T


CARD_CASES = {
    "fsts-T4": lambda: _fst_batch(4),
    "fsts-T6": lambda: _fst_batch(6),
    # S = 45, A = 77: neither a multiple of 32
    "ragged-S-and-A": lambda: (_layered(5, 45, 77, 8, 19, seed=1), 19, 8),
    "padding-and-all-dead-frames": lambda: (_padded(16, 23, seed=2), 23, 16),
    "bench-linear": lambda: (_linear(128, 49, 3080, seed=3), 3080, 49),
    "at-the-limit": lambda: (_layered(2, MAX_STATES, MAX_ARCS, 12, 64,
                                      seed=4), 64, 12),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_kernel_against_plain(case):
    """The kernel against the plain version on the card: log-probs to
    rtol 1e-5 (LOG_ZERO rows exactly), posteriors to 1e-4 / 1e-6, repeats
    bit-identical, one launch a call."""
    dev = _card()
    kw, Pn, T = CARD_CASES[case]()
    B = kw["arc_src"].shape[0]
    graph = _graph(**{n: (torch.from_numpy(v).to(dev) if n in FIELDS else v)
                      for n, v in kw.items()})
    x = torch.randn((B, T, Pn), generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    before = numerator_forward_backward.launches
    lp, post = numerator_forward_backward(graph, x)
    lp2, post2 = numerator_forward_backward(graph, x)
    torch.cuda.synchronize()
    assert numerator_forward_backward.launches == before + 2
    assert torch.equal(lp, lp2) and torch.equal(post, post2)
    with fp32_matmuls():
        rlp, rpost = _forward_backward(graph, x)
    dead = rlp <= LOG_ZERO
    assert torch.equal(lp == LOG_ZERO, dead)
    torch.testing.assert_close(lp[~dead], rlp[~dead], rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post, rpost, rtol=POST_RTOL, atol=POST_ATOL)
    assert not post[dead].any()
    if case == "padding-and-all-dead-frames":
        assert dead[:3].all() and not dead[3]
    else:
        assert not dead.all()
    # host int32 arrays, and int64 ones on the card, take the same route
    host = _graph(**kw)
    wide = _graph(**{n: (torch.from_numpy(v).to(dev).long()
                         if n in FIELDS and v.dtype == np.int32
                         else torch.from_numpy(v).to(dev) if n in FIELDS
                         else v) for n, v in kw.items()})
    for g in (host, wide):
        lp3, post3 = numerator_forward_backward(g, x)
        assert torch.equal(lp3, lp) and torch.equal(post3, post)
    assert numerator_forward_backward.launches == before + 4


@pytest.mark.gpu
def test_cuda_limits_are_the_sources():
    _card()
    from kaldi_fp16_tpu_torch.ops._build import library
    assert library().numerator_max_states() == MAX_STATES
    assert library().numerator_max_arcs() == MAX_ARCS
