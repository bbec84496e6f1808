"""Streaming (online) inference: chunked acoustic forward and incremental
Viterbi with bounded latency.

The torch counterpart of kaldi_fp16_tpu/decode/streaming.py, with the same
classes and methods:

* **StreamingEncoder** — the acoustic model consumes fixed-size input
  chunks (`subsample * chunk_out` frames) and emits `chunk_out` posterior
  frames per step once warm.  Each step runs `Network.forward` (no
  gradient, no frame-grid subsampling) on a fixed window of
  `left_ctx + chunk_in + right_ctx` frames and keeps the central outputs.
  The stream is padded with replicated first and last frames, as in Kaldi
  online2, so the streamed output equals the OFFLINE forward of that
  edge-padded utterance (`offline_reference`, the contract oracle) and
  does not depend on the chunk size.  The window context comes from
  `Model.time_context()`.  Algorithmic latency: right_ctx input frames,
  rounded up to whole chunks.

* **StreamingDecoder** — incremental Viterbi over an epsilon-free
  DecodingGraph: the [S, B] score front carries across chunks through the
  frame step of the offline decoder (`_Arcs.viterbi_step` of
  decode/device_viterbi.py, candidates `(score[src] + w) + scale *
  ll[pdf]`, ties to the smallest arc id), so `finalize()` equals
  `SparseViterbiDecoder.decode_batch` on the concatenated loglikes bit for
  bit.  The per-chunk backpointer tables ([C, S, B] int32) stay on the
  device and the traceback runs there, so only [T, B] int32 arc ids reach
  the host.  Device memory grows T*S*B*4 bytes per stream.

* **WindowedStreamingDecoder** — the same recursion with a bounded
  backpointer window and traceback-delay commits, for HCLG-scale streams,
  through the segment layout's frame step or the tree-ELL one
  (`layout="tree"`, equal to the offline tree decode bit for bit), its
  rows split over the ranks of a data group (`mesh`).

* **StreamingPipeline** — features in, hypotheses out; hides the encoder
  warm-up lag from the decoder.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from kaldi_fp16_tpu_torch.decode.device_viterbi import (
    NEG_INF, ArcGraph, _Arcs, _loglikes, _Rows, _traceback, _Tree,
    _viterbi_frames,
)
from kaldi_fp16_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# acoustic encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EncoderState:
    buf: Optional[torch.Tensor]     # [B, Wbuf, D] rolling padded window
    ivectors: Optional[torch.Tensor]
    fed: int                        # chunks fed
    emitted: int                    # chunks emitted


class StreamingEncoder:
    """Chunked acoustic-model forward with context carry (see module
    docstring), over an explicit EncoderState.  `net` is a
    models.network.Network on `device` (default: the current CUDA
    device)."""

    def __init__(self, net, chunk_out: int = 16, subsample: int = 3,
                 context=None, compute_dtype=torch.bfloat16,
                 output: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.net = net
        self.model = net.model
        self.chunk_out = int(chunk_out)
        self.subsample = int(subsample)
        self.cin = self.subsample * self.chunk_out
        ctx_l, ctx_r = (context if context is not None
                        else self.model.time_context())
        self.ctx_l, self.ctx_r = int(ctx_l), int(ctx_r)
        self.W = self.ctx_l + self.cin + self.ctx_r
        self.lag = -(-self.ctx_r // self.cin)            # chunks of latency
        self.Wbuf = self.ctx_l + (self.lag + 1) * self.cin
        self.compute_dtype = compute_dtype
        self.out_name = output or self.model.chain_output().name

    def _forward(self, x, ivectors, compute_dtype, output=None):
        """Network outputs [B, T, P] of the chain (or `output`) head."""
        with torch.no_grad():
            outs, _ = self.net(x, ivectors, train=False,
                               compute_dtype=compute_dtype)
        return outs[output or self.out_name]

    def init(self, ivectors=None) -> EncoderState:
        if ivectors is not None:
            ivectors = torch.as_tensor(ivectors, dtype=torch.float32,
                                       device=self.device)
        return EncoderState(buf=None, ivectors=ivectors, fed=0, emitted=0)

    def feed(self, st: EncoderState, x) -> tuple:
        """x [B, chunk_in, D] -> (state', posteriors [B, k*chunk_out, P])
        with k == 0 during warm-up (the first `lag` feeds) and 1 after."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape[1] != self.cin:
            raise ValueError(f"fixed chunk size {self.cin} required, got "
                             f"{x.shape[1]}")
        # torch.cat writes a new tensor: the previous window, which an
        # enqueued forward may still read, is never overwritten
        if st.buf is None:
            pad = x[:, :1].expand(-1, self.Wbuf - self.cin, -1)
            buf = torch.cat([pad, x], dim=1)
        else:
            buf = torch.cat([st.buf[:, x.shape[1]:], x], dim=1)
        fed = st.fed + 1
        if fed <= self.lag:                              # warming up
            return (replace(st, buf=buf, fed=fed),
                    torch.zeros((x.shape[0], 0, 1), device=self.device))
        y = self._forward(buf[:, :self.W], st.ivectors, self.compute_dtype)
        lo = self.ctx_l
        hi = lo + (self.chunk_out - 1) * self.subsample + 1
        return (replace(st, buf=buf, fed=fed, emitted=st.emitted + 1),
                y[:, lo:hi:self.subsample])

    def flush(self, st: EncoderState) -> tuple:
        """Emit the pending `lag` chunks by feeding last-frame padding."""
        if st.buf is None:
            return st, torch.zeros((0, 0, 1), device=self.device)
        outs = []
        for _ in range(self.lag):
            st, p = self.feed(st, st.buf[:, -1:].expand(-1, self.cin, -1))
            if p.shape[1]:
                outs.append(p)
        cat = (torch.cat(outs, dim=1) if outs
               else torch.zeros((st.buf.shape[0], 0, 1), device=self.device))
        return st, cat

    def offline_reference(self, x_full, ivectors=None,
                          compute_dtype=torch.bfloat16,
                          output: Optional[str] = None):
        """The contract oracle: offline forward of the edge-padded
        utterance, outputs at stride `subsample` from offset ctx_l.
        x_full [B, T, D] with T a multiple of chunk_in; compute_dtype
        defaults to bfloat16, as in the JAX package, whatever the
        encoder's (pass `compute_dtype=enc.compute_dtype` to match it)."""
        x = torch.as_tensor(x_full, dtype=torch.float32, device=self.device)
        if ivectors is not None:
            ivectors = torch.as_tensor(ivectors, dtype=torch.float32,
                                       device=self.device)
        pad_l = x[:, :1].expand(-1, self.ctx_l, -1)
        pad_r = x[:, -1:].expand(-1, self.lag * self.cin, -1)
        padded = torch.cat([pad_l, x, pad_r], dim=1)
        y = self._forward(padded, ivectors, compute_dtype, output)
        n_out = x.shape[1] // self.subsample
        lo = self.ctx_l
        hi = lo + (n_out - 1) * self.subsample + 1
        return y[:, lo:hi:self.subsample]


# ---------------------------------------------------------------------------
# incremental Viterbi
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecoderState:
    score: torch.Tensor             # [S, B]
    bps: tuple                      # device int32 [C, S, B] per chunk
    frames: int


def _arc_viterbi_chunk(g: _Arcs, score, ll):
    """Streaming chunk step: carry `score` [S, B] across calls; ll
    [B, C, P] -> (score' [S, B], bps [C, S, B] int32), through the offline
    decoder's recursion on the same [P, B] frame layout."""
    return _viterbi_frames(g, score, ll.permute(1, 2, 0).contiguous())


def _walk(g: _Arcs, bps_chunks, last) -> torch.Tensor:
    """Device traceback over the chunks' backpointers from states `last`
    [B] (int64) -> arcs taken [sum C, B] int32, in time order.  The
    offline decoders' reverse walk (device_viterbi._traceback), so
    tie-breaks match decode_batch; both streaming decoders use it."""
    n = sum(int(b.shape[0]) for b in bps_chunks)
    arcs = torch.empty((n, last.shape[0]), dtype=torch.int32,
                       device=last.device)
    state, t1 = last, n
    for bps in reversed(bps_chunks):
        t0 = t1 - int(bps.shape[0])
        state = _traceback(g, bps, state, arcs[t0:t1])
        t1 = t0
    return arcs


def _hyps_from_arcs(arcs, best, arcs_taken) -> List[dict]:
    """Arc-id path [T, B] + final scores [B] -> hypothesis dicts; the same
    post-processing as SparseViterbiDecoder.decode_batch, shared by both
    streaming decoders."""
    A = len(arcs.src)
    oks = (best > NEG_INF / 2) & (arcs_taken < A).all(axis=0)
    safe = np.minimum(arcs_taken, A - 1)
    il = arcs.ilabel[safe]
    ol = arcs.olabel[safe]
    results = []
    for b in range(best.shape[0]):
        ok = bool(oks[b])
        results.append({"words": ol[:, b][ol[:, b] > 0].tolist()
                        if ok else [],
                        "alignment": il[:, b].tolist() if ok else [],
                        "total_cost": -float(best[b]),
                        "final_reached": ok})
    return results


class StreamingDecoder:
    """Incremental exact Viterbi (see module docstring), on `device`
    (default: the current CUDA device)."""

    def __init__(self, graph, acoustic_scale: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.arcs = ArcGraph.from_graph(graph)
        self._g = _Arcs(self.arcs, acoustic_scale, self.device)
        self._final = np.asarray(self.arcs.final)

    def init(self, batch: int) -> DecoderState:
        return DecoderState(score=self._g.start_scores(batch), bps=(),
                            frames=0)

    def feed(self, st: DecoderState, loglikes) -> DecoderState:
        """loglikes [B, C, P]; C may vary per call."""
        ll = _loglikes(loglikes, self.device)
        score, bps = _arc_viterbi_chunk(self._g, st.score, ll)
        return DecoderState(score=score, bps=st.bps + (bps,),
                            frames=st.frames + int(ll.shape[1]))

    def _traceback(self, st: DecoderState, last: np.ndarray) -> np.ndarray:
        state = torch.from_numpy(last.astype(np.int64)).to(self.device)
        return _walk(self._g, st.bps, state).cpu().numpy()

    def partial(self, st: DecoderState) -> List[dict]:
        """Best hypothesis so far, ignoring final weights (results carry
        final_reached=False: the stream is unfinished)."""
        if st.frames == 0:
            return []
        score = st.score.cpu().numpy()
        last = score.argmax(axis=0)
        res = _hyps_from_arcs(self.arcs, score.max(axis=0),
                              self._traceback(st, last))
        for r in res:
            r["final_reached"] = False
        return res

    def finalize(self, st: DecoderState) -> List[dict]:
        """Apply final weights and trace back: equals the offline
        SparseViterbiDecoder.decode_batch on the concatenated frames."""
        total = st.score.cpu().numpy() + self._final[:, None]
        last = total.argmax(axis=0)
        return _hyps_from_arcs(self.arcs, total.max(axis=0),
                               self._traceback(st, last))


# ---------------------------------------------------------------------------
# HCLG-scale streaming: windowed commits
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowedDecoderState:
    score: torch.Tensor         # [S, B] carried Viterbi front (this
                                # rank's streams under a mesh)
    bps: tuple                  # device int32 [C_i, S, B] window chunks
    frames: int                 # total frames fed
    committed: tuple            # host np int32 [F_j, B] locked arc ids

    @property
    def window_frames(self) -> int:
        return sum(int(b.shape[0]) for b in self.bps)

    @property
    def committed_frames(self) -> int:
        return sum(int(c.shape[0]) for c in self.committed)


def _stream_layout(layout: str) -> str:
    """'auto' is the arc (segment) step at every scale: the JAX package's
    auto takes the tree above 64K arcs because of the TPU's scatter."""
    if layout == "auto":
        return "arc"
    if layout not in ("arc", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout


class WindowedStreamingDecoder:
    """Streaming Viterbi for HCLG-scale graphs with BOUNDED device memory:
    a sliding `window`-frame backpointer buffer with traceback-delay
    commits (StreamingDecoder grows T*S*B*4 bytes with stream length).

    Per feed of a C-frame loglike chunk:
      1. the frame recursion runs on the device through the offline
         decoder's frame step (`layout`), appending a [C, S, B]
         winning-arc table to the window;
      2. while the window exceeds `window` frames, the decoder traces back
         from the CURRENT best state over the buffered chunks (on the
         device) and COMMITS the arcs of the oldest chunk(s), dropping
         their backpointer tables; only the committed chunks' [C, B] arc
         ids reach the host.

    Exactness contract (delay-adjusted): frames committed at delay >=
    `window` are locked from the best path at commit time.  finalize()
    equals the offline decode_batch exactly whenever every commit-time
    best path agrees with the final best path over the committed prefix
    (Kaldi online2's partial traceback: beams that have converged by
    `window` frames back never differ).  Under late contrary evidence the
    committed prefix may differ from offline; the tail (the last <= window
    frames) is always exact.

    Device memory: score [S, B] + at most (window + C) backpointer frames
    of [S, B] int32, independent of stream length.

    layout: 'auto' and 'arc' take the arc step (the segment layout's),
    'tree' the tree-ELL step over rows of at most `tree_max_width` slots
    (device_viterbi._Tree); the two give the same results
    (tests/test_streaming.py:229 pins tree = arc in the JAX package).

    mesh: a parallel.mesh.DataGroup on this decoder's device: each rank
    carries the score front and backpointer window of its batch / world
    streams, and each commit, partial and finalize gives every rank the
    arcs of all streams in one all-reduce."""

    def __init__(self, graph, acoustic_scale: float = 1.0,
                 window: int = 96, layout: str = "auto",
                 tree_max_width: int = 128, mesh=None, device=None):
        self.layout = _stream_layout(layout)
        self.device = resolve_device(device)
        self._rows = _Rows(mesh, self.device)
        self.arcs = ArcGraph.from_graph(graph)
        self.window = int(window)
        self._g = (_Tree(self.arcs, acoustic_scale, self.device,
                         tree_max_width) if self.layout == "tree"
                   else _Arcs(self.arcs, acoustic_scale, self.device))
        self._final = np.asarray(self.arcs.final)

    def init(self, batch: int) -> WindowedDecoderState:
        r0, r1 = self._rows.span(batch)
        return WindowedDecoderState(score=self._g.start_scores(r1 - r0),
                                    bps=(), frames=0, committed=())

    def _batch(self, st: WindowedDecoderState) -> int:
        return int(st.score.shape[1]) * (self._rows.group.world
                                         if self._rows.group else 1)

    def _window_traceback(self, st: WindowedDecoderState, best, last):
        """Device traceback over the buffered window from this rank's
        states `last` [b] -> (best [B], per-chunk host arc arrays in time
        order), all streams' in one transfer."""
        state = torch.from_numpy(last.astype(np.int64)).to(self.device)
        arcs = _walk(self._g, st.bps, state)
        best_t = torch.from_numpy(best.astype(np.float32)).to(self.device)
        best_t, arcs = self._rows.join(self._batch(st), best_t[None], arcs)
        arcs = arcs.cpu().numpy()
        return best_t[0].cpu().numpy(), np.split(
            arcs, np.cumsum([int(b.shape[0]) for b in st.bps])[:-1])

    def feed(self, st: WindowedDecoderState,
             loglikes) -> WindowedDecoderState:
        """loglikes [B, C, P].  Runs the recursion, then commits any frames
        older than `window` by a traceback from the current best state."""
        ll = _loglikes(loglikes, self.device)
        B = ll.shape[0]
        r0, r1 = self._rows.span(B)
        score, bps_new = _arc_viterbi_chunk(self._g, st.score, ll[r0:r1])
        bps = st.bps + (bps_new,)
        frames = st.frames + int(ll.shape[1])
        committed = st.committed
        sizes = [int(b.shape[0]) for b in bps]
        buffered = sum(sizes)
        if buffered > self.window:
            # how many of the oldest chunks have fully left the window
            # (every commit happens at traceback delay >= window)?  From
            # the host-known chunk sizes first, so a feed that commits
            # nothing skips the device walk and the transfer
            n_drop = 0
            while (n_drop < len(sizes)
                   and buffered - sum(sizes[:n_drop + 1]) >= self.window):
                n_drop += 1
            if n_drop:
                # one walk through ALL buffered chunks reaches the oldest;
                # only the committed chunks' arcs are shipped
                state = torch.argmax(score, dim=0)
                arcs = _walk(self._g, bps, state)
                n = sum(sizes[:n_drop])
                host = self._rows.join(B, arcs[:n])[0].cpu().numpy()
                committed = committed + tuple(
                    np.split(host, np.cumsum(sizes[:n_drop])[:-1]))
                bps = bps[n_drop:]
        return WindowedDecoderState(score=score, bps=bps, frames=frames,
                                    committed=committed)

    def _assemble(self, best, committed, tail_arcs) -> List[dict]:
        arcs_all = list(committed) + list(tail_arcs)
        arcs_taken = (np.concatenate(arcs_all, axis=0) if arcs_all
                      else np.zeros((0, len(best)), np.int32))
        return _hyps_from_arcs(self.arcs, best, arcs_taken)

    def partial(self, st: WindowedDecoderState) -> List[dict]:
        """Committed prefix + current-window best continuation, final
        weights ignored."""
        if st.frames == 0:
            return []
        score = st.score.cpu().numpy()
        best, tail = self._window_traceback(st, score.max(axis=0),
                                            score.argmax(axis=0))
        res = self._assemble(best, st.committed, tail)
        for r in res:
            r["final_reached"] = False
        return res

    def finalize(self, st: WindowedDecoderState) -> List[dict]:
        """Final-weighted traceback of the window appended to the committed
        prefix."""
        total = st.score.cpu().numpy() + self._final[:, None]
        best, tail = self._window_traceback(st, total.max(axis=0),
                                            total.argmax(axis=0))
        return self._assemble(best, st.committed, tail)


# ---------------------------------------------------------------------------
# end-to-end pipeline
# ---------------------------------------------------------------------------

class StreamingPipeline:
    """Features in, hypotheses out; hides the encoder warm-up lag."""

    def __init__(self, encoder: StreamingEncoder, decoder):
        self.enc = encoder
        self.dec = decoder

    def init(self, batch: int, ivectors=None):
        return (self.enc.init(ivectors), self.dec.init(batch))

    def feed(self, st, features):
        enc_st, dec_st = st
        enc_st, posts = self.enc.feed(enc_st, features)
        if posts.shape[1]:
            dec_st = self.dec.feed(dec_st, posts)
        return (enc_st, dec_st)

    def partial(self, st) -> List[dict]:
        return self.dec.partial(st[1])

    def finalize(self, st) -> List[dict]:
        enc_st, dec_st = st
        enc_st, posts = self.enc.flush(enc_st)
        if posts.shape[1]:
            dec_st = self.dec.feed(dec_st, posts)
        return self.dec.finalize(dec_st)
