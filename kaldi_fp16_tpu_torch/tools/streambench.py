"""streambench: streaming-inference latency and throughput.

The twin of tools/streambench.py (decode/streaming.py): per-chunk encoder
step latency, end-to-end pipeline chunk latency (encoder + incremental
Viterbi feed through `StreamingPipeline`), real-time factor and the
algorithmic latency (context lookahead + chunk), at flagship scale on the
device.  Each timed call ends in `torch.cuda.synchronize()` on a card (as
the JAX tool blocks on each result), so a time spans the device work and
the host's enqueue; with `--device cpu` it is the host clock.

Flags as tools/streambench.py's, with --device added.  The network has
random weights from seed 0; the --hclg graph is
tools.decodebench.synth_hclg_graph; the windowed decoder takes its
"auto" layout, the arc step at every scale (the JAX package's auto takes
the tree-ELL step above 64K arcs; the port's is `layout="tree"`, with the
same results).  Prints one JSON row per chunk size with the JAX tool's
keys; `main(argv)` returns the rows.

Usage: python -m kaldi_fp16_tpu_torch.tools.streambench [--batch 8]
       [--chunks 6,16,32] [--decode-only] [--hclg] [--decoder windowed]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.streambench")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chunks", default="6,16,32",
                    help="comma list of chunk_out sizes (output frames)")
    ap.add_argument("--xconfig", default="configs/cnn_tdnn.xconfig")
    ap.add_argument("--graph-states", type=int, default=2048)
    ap.add_argument("--graph-arcs", type=int, default=16384)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frame-shift-ms", type=float, default=10.0)
    ap.add_argument("--hclg", action="store_true",
                    help="HCLG-shaped graph (decodebench.synth_hclg_graph "
                         "word chains + LM fan-out) at --graph-states scale")
    ap.add_argument("--decoder", choices=["incremental", "windowed"],
                    default="incremental",
                    help="incremental = exact unbounded-memory "
                         "StreamingDecoder; windowed = bounded "
                         "WindowedStreamingDecoder (HCLG-scale serving "
                         "shape, traceback-delay commits)")
    ap.add_argument("--window", type=int, default=96,
                    help="windowed decoder: backpointer window / commit "
                         "delay in frames")
    ap.add_argument("--decode-only", action="store_true",
                    help="skip the acoustic encoder: feed synthetic "
                         "loglikes, isolating decoder feed cost (use "
                         "for S>=100K graph benches)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def random_graph(rng, S: int, A: int, pdfs: int):
    """The JAX tool's synthetic decode graph (tools/streambench.py:72-82):
    the last 7 states final, A arcs with random source, pdf ilabel,
    weight, destination and word olabel, drawn from `rng` in that order."""
    from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState

    states = [FstState(final=(0.0 if s > S - 8 else np.inf))
              for s in range(S)]
    for _ in range(A):
        s = int(rng.integers(0, S))
        states[s].arcs.append(FstArc(
            int(rng.integers(1, pdfs + 1)),
            float(rng.uniform(0.1, 2.0)),
            int(rng.integers(0, S)),
            olabel=int(rng.integers(0, 1000))))
    return DecodingGraph.from_fst(Fst(start=0, states=states))


def bench_graph(args, rng):
    """The graph the tool decodes: HCLG-shaped with --hclg, else
    random_graph (which draws from rng, as the JAX tool does)."""
    if args.hclg:
        from kaldi_fp16_tpu_torch.tools.decodebench import synth_hclg_graph
        return synth_hclg_graph(args.graph_states, args.pdfs)
    return random_graph(rng, args.graph_states, args.graph_arcs, args.pdfs)


def _timed(fn, iters: int, device) -> float:
    """Mean ms per call of fn(), each call ending in a device sync."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> list:
    from kaldi_fp16_tpu_torch.decode.streaming import (
        StreamingDecoder, StreamingEncoder, StreamingPipeline,
        WindowedStreamingDecoder,
    )
    from kaldi_fp16_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    B = args.batch
    graph = bench_graph(args, rng)
    chunks = [int(c) for c in args.chunks.split(",")]
    rows = []

    def make_decoder():
        if args.decoder == "windowed":
            return WindowedStreamingDecoder(graph, acoustic_scale=1.0,
                                            window=args.window,
                                            device=device)
        return StreamingDecoder(graph, acoustic_scale=1.0, device=device)

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.decode_only:
        # decoder-feed cost in isolation (synthetic posteriors)
        for co in chunks:
            dec = make_decoder()
            ll = torch.from_numpy(rng.normal(size=(B, co, args.pdfs))
                                  .astype(np.float32)).to(device)
            st = dec.init(B)
            # reach steady state (window full, commits every feed)
            feeds = (args.window // co + 2 if args.decoder == "windowed"
                     else 1)
            for _ in range(feeds + 1):
                st = dec.feed(st, ll)
            box = [st]

            def feed():
                box[0] = dec.feed(box[0], ll)

            feed_ms = _timed(feed, args.iters, device)
            st = box[0]
            chunk_audio_ms = co * 3 * args.frame_shift_ms  # output rate /3
            row = {
                "decoder": args.decoder, "chunk_out": co, "batch": B,
                "graph": {"S": graph.num_states, "A": len(dec.arcs.src),
                          "hclg": bool(args.hclg)},
                "decode_feed_ms_per_chunk": round(feed_ms, 2),
                "audio_sec_per_s": round(B * chunk_audio_ms / feed_ms, 1),
                "rtf_per_stream": round(feed_ms / chunk_audio_ms, 4),
            }
            if args.decoder == "windowed":
                row["window_frames"] = st.window_frames
                row["committed_frames"] = st.committed_frames
                row["bp_window_mb"] = round(
                    st.window_frames * graph.num_states * B * 4 / 2**20, 1)
            emit(row)
        return rows

    from kaldi_fp16_tpu_torch.models.model import build_model
    from kaldi_fp16_tpu_torch.models.network import Network

    model = build_model(args.xconfig)
    net = Network(model, torch.Generator(device=device).manual_seed(0),
                  device)
    net.eval()
    feat_dim = ivec_dim = None
    for inp in model.inputs():
        if inp.name == "ivector":
            ivec_dim = inp.spec.dim
        else:
            feat_dim = inp.spec.dim
    ivec = (rng.normal(size=(B, ivec_dim)).astype(np.float32)
            if ivec_dim else None)
    for co in chunks:
        enc = StreamingEncoder(net, chunk_out=co, device=device)
        pipe = StreamingPipeline(enc, make_decoder())
        cin = enc.cin
        x = torch.from_numpy(rng.normal(size=(B, cin, feat_dim))
                             .astype(np.float32)).to(device)

        # warm up: fill the encoder's lag, then one decoder feed
        box = [pipe.init(B, ivec)]
        for _ in range(enc.lag + 1):
            box[0] = pipe.feed(box[0], x)

        def enc_feed():
            est, p = enc.feed(box[0][0], x)
            box[0] = (est, box[0][1])

        def pipe_feed():
            box[0] = pipe.feed(box[0], x)

        enc_ms = _timed(enc_feed, args.iters, device)
        e2e_ms = _timed(pipe_feed, args.iters, device)
        chunk_audio_ms = cin * args.frame_shift_ms
        alg_latency_ms = (enc.ctx_r + cin) * args.frame_shift_ms
        emit({
            "chunk_out": co, "chunk_in": cin, "batch": B,
            "ctx": [enc.ctx_l, enc.ctx_r], "lag_chunks": enc.lag,
            "encoder_ms_per_chunk": round(enc_ms, 2),
            "e2e_ms_per_chunk": round(e2e_ms, 2),
            "rtf_per_stream": round(e2e_ms / chunk_audio_ms, 4),
            "streams_at_realtime": int(B * chunk_audio_ms
                                       // max(e2e_ms, 1e-9)),
            "algorithmic_latency_ms": alg_latency_ms,
            "graph": {"S": graph.num_states, "A": len(pipe.dec.arcs.src),
                      "hclg": bool(args.hclg)},
            "decoder": args.decoder,
        })
    return rows


if __name__ == "__main__":
    main()
