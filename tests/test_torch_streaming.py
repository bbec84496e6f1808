"""The port's streaming inference against its offline paths and the JAX
package's decode/streaming.py.

Mirrors tests/test_streaming.py: the same narrow network (JAX weights
loaded into the port with `params_from_jax`), the same small cyclic
graphs and seeded loglikes, the same chunk schedules.  Bars:

  * encoder vs its own `offline_reference`: rtol = atol = 2e-5 in fp32,
    0.1 in bf16 (tests/test_streaming.py:92, :102);
  * encoder vs the JAX encoder: 1e-4, the fp32 network bar
    (tests/test_torch_network.py);
  * streaming decoders vs the port's offline decoder: bit for bit (the
    same frame step on the same device);
  * vs the JAX decoders: words, alignments and final_reached equal, costs
    within 1e-4 (tests/test_streaming.py:127); committed arc ids equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaldi_fp16_tpu.decode import streaming as js
from kaldi_fp16_tpu.decode.tpu_viterbi import (
    SparseViterbiDecoder as JaxSparse,
)
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
from kaldi_fp16_tpu.models.model import (
    build_model_from_string as jax_build_from_string,
)
from kaldi_fp16_tpu.models.network import Network as JaxNetwork
from kaldi_fp16_tpu_torch.convert import params_from_jax
from kaldi_fp16_tpu_torch.decode import streaming as ps
from kaldi_fp16_tpu_torch.decode.device_viterbi import SparseViterbiDecoder
from kaldi_fp16_tpu_torch.models.model import (
    build_model, build_model_from_string,
)
from kaldi_fp16_tpu_torch.models.network import Network
from tests.test_streaming import XCONFIG
from tests.test_torch_decode_host import both_graphs

FP32 = dict(rtol=2e-5, atol=2e-5)       # tests/test_streaming.py:92
BF16 = dict(rtol=0.1, atol=0.1)         # ibid. :102
VS_JAX = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_network.py
COST_ATOL = 1e-4                        # tests/test_streaming.py:127


@pytest.fixture(scope="module")
def nets():
    """(JAX model, params, state) and the port's Network with the same
    weights, on the CPU."""
    jm = jax_build_from_string(XCONFIG)
    params, state = JaxNetwork(jm).init(jax.random.PRNGKey(0))
    pm = build_model_from_string(XCONFIG)
    net = Network(pm, torch.Generator(), device="cpu")
    net.load_state_dict(params_from_jax(pm, params, state), strict=True)
    return (jm, params, state), net


def random_fst(num_pdfs=6, num_states=5, seed=0):
    """tests/test_streaming.py's random_graph, as an Fst."""
    rng = np.random.default_rng(seed)
    states = [FstState(final=(0.5 if s >= num_states - 2 else np.inf))
              for s in range(num_states)]
    for s in range(num_states):
        for _ in range(3):
            states[s].arcs.append(FstArc(
                int(rng.integers(1, num_pdfs + 1)),
                float(rng.uniform(0.1, 1.0)),
                int(rng.integers(0, num_states)),
                olabel=int(rng.integers(0, 4))))
    return Fst(start=0, states=states)


def loglikes(B=3, T=24, P=6, seed=2, peaky=0.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, P)).astype(np.float32) * (1.0 + peaky)


def assert_bit_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a["words"], a["alignment"], a["final_reached"],
                a["total_cost"]) == (b["words"], b["alignment"],
                                     b["final_reached"], b["total_cost"])


def assert_close_to_jax(got, ref, cost_atol=COST_ATOL):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a["words"] == b["words"]
        assert a["alignment"] == b["alignment"]
        assert a["final_reached"] == b["final_reached"]
        assert abs(a["total_cost"] - b["total_cost"]) < cost_atol


def feed_all(dec, st, ll, chunks):
    t0 = 0
    for c in chunks:
        st = dec.feed(st, ll[:, t0:t0 + c])
        t0 += c
    return st


class TestModelContext:
    def test_time_context(self):
        model = build_model_from_string(XCONFIG)
        assert model.time_context() == (6, 6)     # two tdnnf at stride 3
        assert (model.time_context()
                == jax_build_from_string(XCONFIG).time_context())

    def test_flagship_context(self):
        left, right = build_model("configs/cnn_tdnn.xconfig").time_context()
        assert left > 10 and right > 10


def run_encoder(enc, x):
    """Stream x [B, T_in, D] through `enc` chunk by chunk, then flush."""
    st = enc.init()
    outs = []
    for i in range(x.shape[1] // enc.cin):
        st, p = enc.feed(st, x[:, i * enc.cin:(i + 1) * enc.cin])
        if p.shape[1]:
            outs.append(np.asarray(p))
    st, p = enc.flush(st)
    if p.shape[1]:
        outs.append(np.asarray(p))
    return np.concatenate(outs, axis=1)


class TestStreamingEncoder:
    def _run(self, nets, chunk_out, T_out=12, B=2, dtype=torch.float32):
        _, net = nets
        enc = ps.StreamingEncoder(net, chunk_out=chunk_out,
                                  compute_dtype=dtype, device="cpu")
        x = np.random.default_rng(1).normal(
            size=(B, T_out * enc.subsample, 8)).astype(np.float32)
        got = run_encoder(enc, x)
        assert got.shape[1] == T_out
        ref = enc.offline_reference(x).float().numpy()
        return got, ref, x

    def test_matches_padded_offline(self, nets):
        got, ref, _ = self._run(nets, chunk_out=4)
        np.testing.assert_allclose(got, ref, **FP32)

    def test_chunk_size_invariance(self, nets):
        got2, ref, _ = self._run(nets, chunk_out=2)
        got6, _, _ = self._run(nets, chunk_out=6)
        np.testing.assert_allclose(got2, ref, **FP32)
        np.testing.assert_allclose(got6, ref, **FP32)

    def test_bf16_compute_close(self, nets):
        got, ref, _ = self._run(nets, chunk_out=4, dtype=torch.bfloat16)
        np.testing.assert_allclose(got, ref, **BF16)

    @pytest.mark.parametrize("chunk_out", [2, 4])
    def test_matches_jax_encoder(self, nets, chunk_out):
        (jm, params, state), _ = nets
        got, ref, x = self._run(nets, chunk_out=chunk_out)
        jenc = js.StreamingEncoder(jm, params, state, chunk_out=chunk_out,
                                   compute_dtype=jnp.float32)
        np.testing.assert_allclose(got, run_encoder(jenc, jnp.asarray(x)),
                                   **VS_JAX)
        jref = jenc.offline_reference(params, state, jnp.asarray(x),
                                      compute_dtype=jnp.float32)
        np.testing.assert_allclose(ref, np.asarray(jref), **VS_JAX)
        enc = ps.StreamingEncoder(nets[1], chunk_out=chunk_out, device="cpu")
        assert (enc.W, enc.lag, enc.Wbuf) == (jenc.W, jenc.lag, jenc.Wbuf)

    def test_warmup_and_fixed_chunk(self, nets):
        _, net = nets
        enc = ps.StreamingEncoder(net, chunk_out=2, device="cpu")
        assert enc.lag == 1
        st, p = enc.feed(enc.init(), np.zeros((2, enc.cin, 8), np.float32))
        assert tuple(p.shape) == (2, 0, 1)
        with pytest.raises(ValueError, match="fixed chunk size"):
            enc.feed(st, np.zeros((2, enc.cin + 1, 8), np.float32))


class TestStreamingDecoder:
    @pytest.mark.parametrize("chunks", [[24], [8, 8, 8], [5, 7, 12]])
    def test_matches_offline(self, chunks):
        jg, pg = both_graphs(random_fst())
        ll = loglikes()
        offline = SparseViterbiDecoder(pg, acoustic_scale=0.7,
                                       device="cpu").decode_batch(ll)
        dec = ps.StreamingDecoder(pg, acoustic_scale=0.7, device="cpu")
        got = dec.finalize(feed_all(dec, dec.init(ll.shape[0]), ll, chunks))
        assert_bit_equal(got, offline)
        jdec = js.StreamingDecoder(jg, acoustic_scale=0.7)
        jres = jdec.finalize(feed_all(jdec, jdec.init(ll.shape[0]), ll,
                                      chunks))
        assert_close_to_jax(got, jres)
        # and the JAX offline decoder, as the JAX test holds its stream
        assert_close_to_jax(got, JaxSparse(jg, acoustic_scale=0.7,
                                           layout="segment").decode_batch(ll))

    def test_partial_monotone(self):
        jg, pg = both_graphs(random_fst(seed=5))
        ll = loglikes(seed=6)
        dec = ps.StreamingDecoder(pg, acoustic_scale=0.7, device="cpu")
        jdec = js.StreamingDecoder(jg, acoustic_scale=0.7)
        st, jst = dec.init(ll.shape[0]), jdec.init(ll.shape[0])
        assert dec.partial(st) == []
        for t1 in (8, 16):
            st = dec.feed(st, ll[:, t1 - 8:t1])
            jst = jdec.feed(jst, ll[:, t1 - 8:t1])
            p = dec.partial(st)
            assert len(p) == ll.shape[0]
            assert all(len(r["alignment"]) == t1 for r in p)
            assert all(not r["final_reached"] for r in p)
            assert_close_to_jax(p, jdec.partial(jst))


class TestWindowedStreamingDecoder:
    def _pair(self, seed, window):
        jg, pg = both_graphs(random_fst(seed=seed))
        return (ps.WindowedStreamingDecoder(pg, acoustic_scale=0.7,
                                            window=window, device="cpu"),
                js.WindowedStreamingDecoder(jg, acoustic_scale=0.7,
                                            window=window, layout="arc"),
                pg, jg)

    @staticmethod
    def _committed_equal(st, jst):
        assert st.committed_frames == jst.committed_frames
        assert st.window_frames == jst.window_frames
        if st.committed:
            np.testing.assert_array_equal(
                np.concatenate(st.committed),
                np.concatenate([np.asarray(c) for c in jst.committed]))

    def _stream(self, dec, jdec, ll, C, check=None):
        st, jst = dec.init(ll.shape[0]), jdec.init(ll.shape[0])
        for t0 in range(0, ll.shape[1], C):
            st = dec.feed(st, ll[:, t0:t0 + C])
            jst = jdec.feed(jst, ll[:, t0:t0 + C])
            self._committed_equal(st, jst)
            if check:
                check(st)
        return st, jst

    @pytest.mark.parametrize("layout", ["auto", "arc"])
    def test_window_covers_stream_matches_offline(self, layout):
        """window >= T: nothing commits early, finalize equals the offline
        decode bit for bit."""
        _, _, pg, jg = self._pair(0, 64)
        dec = ps.WindowedStreamingDecoder(pg, acoustic_scale=0.7, window=64,
                                          layout=layout, device="cpu")
        jdec = js.WindowedStreamingDecoder(jg, acoustic_scale=0.7,
                                           window=64, layout="arc")
        ll = loglikes(T=48)
        st, jst = self._stream(dec, jdec, ll, 8)
        assert st.committed == ()
        got = dec.finalize(st)
        assert_bit_equal(got, SparseViterbiDecoder(
            pg, acoustic_scale=0.7, device="cpu").decode_batch(ll))
        assert_close_to_jax(got, jdec.finalize(jst))

    def test_bounded_window_and_commits(self):
        """Long stream, small window: backpointer frames stay <= window +
        chunk while committed frames grow (the memory bound)."""
        T, C, W = 96, 8, 16
        dec, jdec, _, _ = self._pair(5, W)
        ll = loglikes(T=T, seed=6)

        def bounded(st):
            assert st.window_frames <= W + C
            assert st.committed_frames == st.frames - st.window_frames

        st, jst = self._stream(dec, jdec, ll, C, bounded)
        assert st.committed_frames >= T - W - C
        res = dec.finalize(st)
        assert all(len(r["alignment"]) in (0, T) for r in res)
        assert_close_to_jax(res, jdec.finalize(jst))

    def test_commit_exactness_when_converged(self):
        """Peaked acoustics converge within the window: the windowed
        decode equals the offline one despite commits."""
        T, C, W = 64, 8, 16
        dec, jdec, pg, _ = self._pair(7, W)
        ll = loglikes(T=T, seed=8, peaky=9.0)
        st, jst = self._stream(dec, jdec, ll, C)
        assert st.committed_frames > 0
        got = dec.finalize(st)
        assert_bit_equal(got, SparseViterbiDecoder(
            pg, acoustic_scale=0.7, device="cpu").decode_batch(ll))
        assert_close_to_jax(got, jdec.finalize(jst))

    def test_partial_includes_committed_prefix(self):
        T, C, W = 48, 8, 16
        dec, jdec, _, _ = self._pair(9, W)
        ll = loglikes(T=T, seed=10)
        st, jst = self._stream(dec, jdec, ll, C)
        p = dec.partial(st)
        assert all(len(r["alignment"]) == T for r in p)
        assert all(not r["final_reached"] for r in p)
        assert_close_to_jax(p, jdec.partial(jst))

    def test_tree_layout_and_mesh_raise(self):
        """'tree' builds the tree-ELL step and 'auto' the arc step; mesh
        takes a DataGroup on the decoder's device, anything else raises
        TypeError; 'ell' is no windowed layout and raises ValueError."""
        from kaldi_fp16_tpu_torch.decode.device_viterbi import _Arcs, _Tree
        from kaldi_fp16_tpu_torch.parallel.mesh import DataGroup
        _, pg = both_graphs(random_fst(seed=11))
        dec = ps.WindowedStreamingDecoder(pg, layout="tree", device="cpu")
        assert dec.layout == "tree" and type(dec._g) is _Tree
        dec = ps.WindowedStreamingDecoder(pg, device="cpu")
        assert dec.layout == "arc" and type(dec._g) is _Arcs
        group = DataGroup(0, 2, "cpu", "gloo")
        dec = ps.WindowedStreamingDecoder(pg, mesh=group, device="cpu")
        with pytest.raises(ValueError, match="divisible"):
            dec.init(3)
        assert dec.init(4).score.shape == (pg.num_states, 2)
        with pytest.raises(TypeError, match="DataGroup"):
            ps.WindowedStreamingDecoder(pg, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="unknown layout"):
            ps.WindowedStreamingDecoder(pg, layout="ell", device="cpu")

    @pytest.mark.parametrize("width", [2, 4, 128])
    def test_tree_stream_matches_offline_tree_and_arc_stream(self, width):
        """tests/test_streaming.py:229: the tree step's stream, with
        commits, equals the arc step's stream (commits included) and the
        JAX tree stream; with the window over the whole stream it equals
        the offline tree decode bit for bit."""
        T, C, W = 64, 8, 16
        jg, pg = both_graphs(random_fst(seed=11))
        ll = loglikes(T=T, seed=12, peaky=4.0)
        tree = ps.WindowedStreamingDecoder(pg, acoustic_scale=0.7, window=W,
                                           layout="tree",
                                           tree_max_width=width,
                                           device="cpu")
        arc, _, _, _ = self._pair(11, W)
        jtree = js.WindowedStreamingDecoder(jg, acoustic_scale=0.7, window=W,
                                            layout="tree",
                                            tree_max_width=width)
        st, jst = self._stream(tree, jtree, ll, C)
        ast = arc.init(ll.shape[0])
        for t0 in range(0, T, C):
            ast = arc.feed(ast, ll[:, t0:t0 + C])
        assert st.committed_frames == ast.committed_frames > 0
        np.testing.assert_array_equal(np.concatenate(st.committed),
                                      np.concatenate(ast.committed))
        got = tree.finalize(st)
        assert_bit_equal(got, arc.finalize(ast))
        assert_close_to_jax(got, jtree.finalize(jst))
        assert_bit_equal(tree.partial(st), arc.partial(ast))
        whole = ps.WindowedStreamingDecoder(pg, acoustic_scale=0.7,
                                            window=T, layout="tree",
                                            tree_max_width=width,
                                            device="cpu")
        st = whole.init(ll.shape[0])
        for t0 in range(0, T, C):
            st = whole.feed(st, ll[:, t0:t0 + C])
        assert st.committed == ()
        offline = SparseViterbiDecoder(pg, acoustic_scale=0.7, layout="tree",
                                       tree_max_width=width, device="cpu")
        assert_bit_equal(whole.finalize(st), offline.decode_batch(ll))


class TestStreamingPipeline:
    def test_end_to_end(self, nets):
        (jm, params, state), net = nets
        x = np.random.default_rng(3).normal(size=(2, 36, 8)) \
            .astype(np.float32)
        jg, pg = both_graphs(random_fst())
        enc = ps.StreamingEncoder(net, chunk_out=4,
                                  compute_dtype=torch.float32, device="cpu")
        pipe = ps.StreamingPipeline(enc, ps.StreamingDecoder(pg,
                                                             device="cpu"))
        jenc = js.StreamingEncoder(jm, params, state, chunk_out=4,
                                   compute_dtype=jnp.float32)
        jpipe = js.StreamingPipeline(jenc, js.StreamingDecoder(jg))
        st, jst = pipe.init(2), jpipe.init(2)
        for i in range(x.shape[1] // enc.cin):
            chunk = x[:, i * enc.cin:(i + 1) * enc.cin]
            st = pipe.feed(st, chunk)
            jst = jpipe.feed(jst, jnp.asarray(chunk))
        res = pipe.finalize(st)
        assert len(res) == 2
        # equals offline: the oracle's posteriors through the offline
        # decoder (tests/test_streaming.py:265-272's bar)
        offline = SparseViterbiDecoder(pg, device="cpu").decode_batch(
            enc.offline_reference(x))
        for a, b in zip(res, offline):
            assert a["words"] == b["words"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-3
        for a, b in zip(res, jpipe.finalize(jst)):
            assert a["words"] == b["words"]
            assert abs(a["total_cost"] - b["total_cost"]) < 1e-3


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")


@pytest.mark.parametrize("name", ["StreamingDecoder",
                                  "WindowedStreamingDecoder",
                                  "StreamingEncoder"])
def test_raises_without_a_device_on_a_cpu_box(no_card, nets, name):
    _, pg = both_graphs(random_fst())
    make = {"StreamingDecoder": lambda **kw: ps.StreamingDecoder(pg, **kw),
            "WindowedStreamingDecoder":
                lambda **kw: ps.WindowedStreamingDecoder(pg, **kw),
            "StreamingEncoder":
                lambda **kw: ps.StreamingEncoder(nets[1], **kw)}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    make(device="cpu")
