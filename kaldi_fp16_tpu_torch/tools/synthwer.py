"""synthwer: closed-loop WER on synthetic speech.

The twin of tools/synthwer.py.  It trains the chain model on utterances
generated from a KNOWN word/phone/pdf process, decodes held-out
utterances through a word-loop graph on the device, and reports the WER
falling as training converges.  cegs ark IO, the DataLoader, the LF-MMI
Trainer (numerator and denominator forward-backward), the acoustic
forward, the decoding graph, the device Viterbi decoder and WER scoring
must all work together for the error rate to reach zero.

Each word is a phone sequence; each phone emits `--dur` supervision frames
whose input features are a per-phone mean vector + noise.  The decoding
graph is an epsilon-free word loop with per-phone self-loops (durations
>= 1 accepted), word olabels on word-entry arcs.  `--streaming` also
decodes through the windowed streaming decoder, `--lm-rescore` through
device lattices rescored with a bigram ARPA LM from the training
transcripts.

Flags as tools/synthwer.py's, with --device in place of --cpu (default:
the current CUDA device).  The data, lexicon and LM come from `--seed` as
in the JAX tool; the network's initial weights come from the Trainer's
torch generator, so the WER trajectory is the port's own.  Prints one JSON
line per evaluation, the streaming and rescoring lines, and a final
summary {"ok": ..., "wer_first": ..., "wer_final": ...}; `main(argv)`
returns that summary with "history", "streaming", "lm_rescore" and the
"trainer" added.

Usage:
  python -m kaldi_fp16_tpu_torch.tools.synthwer [--device cpu]
      [--steps 150] [--batch 16] [--phones 12] [--words 6]
      [--phones-per-word 2] [--dur 2] [--words-per-utt 3] [--feat-dim 24]
      [--eval-every 30] [--ambiguous] [--zipf 1.2] [--lm-rescore]
      [--lm-weight 1.0] [--lattice-beam 8.0] [--max-dur 4] [--streaming]
      [--stream-chunk 6] [--stream-window 12]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch

LEFT, RIGHT, STRIDE = 3, 5, 3


def build_xconfig(feat_dim: int, num_pdfs: int, dim: int = 48) -> str:
    return f"""\
input name=input dim={feat_dim}
linear-component name=linear1 dim={dim}
batchnorm-component name=bn1
tdnnf-layer name=tdnnf1 dim={dim} bottleneck-dim={dim // 2} time-stride=1 bypass-scale=0.66
tdnnf-layer name=tdnnf2 dim={dim} bottleneck-dim={dim // 2} time-stride=3 bypass-scale=0.66
prefinal-layer name=prefinal small-dim={dim // 2} big-dim={dim}
output-layer name=output dim={num_pdfs} include-log-softmax=false
"""


def make_lexicon(rng, phones: int, words: int, ppw: int,
                 disjoint: bool = True):
    """Phone sequences, one per word id 1..words.  `disjoint` (default)
    partitions the phone set across words so the word loop has no
    segmentation ambiguity and 0% WER is reachable; non-disjoint words
    share phones, leaving genuine LM-free homophone-boundary ambiguity."""
    if disjoint:
        assert phones >= words * ppw, (
            f"--disjoint needs phones >= words*phones_per_word "
            f"({phones} < {words}*{ppw})")
        perm = [int(p) for p in rng.permutation(phones)]
        return {w + 1: tuple(perm[w * ppw:(w + 1) * ppw])
                for w in range(words)}
    if phones ** ppw < words:
        raise SystemExit(f"only {phones ** ppw} distinct "
                         f"{ppw}-phone sequences exist over {phones} "
                         f"phones — cannot build {words} words")
    lex, seen = {}, set()
    w = 1
    while w <= words:
        seq = tuple(int(p) for p in rng.integers(0, phones, size=ppw))
        if seq in seen:
            continue
        seen.add(seq)
        lex[w] = seq
        w += 1
    return lex


def sample_utt(rng, lex, words_per_utt: int, dur: int,
               zipf: float = 0.0, max_dur: int = 0):
    """-> (word ids, supervision pdf sequence 0-indexed).  `zipf` skews
    the word distribution (p proportional to rank^-zipf; 0 = uniform).
    `max_dur` > dur draws each phone's duration uniformly from
    [dur, max_dur], so utterance lengths vary."""
    n = len(lex)
    p = np.arange(1, n + 1, dtype=np.float64) ** -zipf
    p /= p.sum()
    ws = [int(w) + 1 for w in rng.choice(n, size=words_per_utt, p=p)]
    hi = max(max_dur, dur)
    pdfs = [p_ for w in ws for p_ in lex[w]
            for _ in range(int(rng.integers(dur, hi + 1)))]
    return ws, np.asarray(pdfs, np.int64)


def features_for(rng, pdf_seq, means, noise: float):
    """Input-frame features at STRIDE x the supervision rate: row r
    carries the mean vector of the nearest supervision frame's pdf."""
    fps = len(pdf_seq)
    t_in = LEFT + (fps - 1) * STRIDE + 1 + RIGHT
    rows = np.clip(np.round((np.arange(t_in) - LEFT) / STRIDE), 0,
                   fps - 1).astype(np.int64)
    feats = means[pdf_seq[rows]] + rng.normal(
        size=(t_in, means.shape[1])) * noise
    return feats.astype(np.float32)


def make_example(rng, key, lex, args, means):
    from kaldi_fp16_tpu_torch.io.egs import (
        Example, Index, IoBlock, Supervision,
    )
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    ws, pdfs = sample_utt(rng, lex, args.words_per_utt, args.dur,
                          zipf=args.zipf, max_dur=args.max_dur)
    fps = len(pdfs)
    states = [FstState() for _ in range(fps + 1)]
    for i, p in enumerate(pdfs):          # linear chain, 1-indexed labels
        states[i].arcs.append(FstArc(int(p) + 1, 0.0, i + 1))
    states[-1].final = 0.0
    sup = Supervision(name="output", weight=1.0, num_sequences=1,
                      frames_per_seq=fps, label_dim=args.phones,
                      end2end=False, fst=Fst(start=0, states=states),
                      indexes=[Index(0, i * STRIDE, 0) for i in range(fps)],
                      deriv_weights=np.ones(fps, np.float32))
    feats = features_for(rng, pdfs, means, args.noise)
    ex = Example(key=key, inputs=[
        IoBlock("input", [Index(0, t - LEFT, 0)
                          for t in range(feats.shape[0])], feats, "CM")],
        supervision=sup)
    return ex, ws


def write_arpa(path: str, transcripts, n_words: int, k: float = 0.5):
    """Order-2 ARPA estimated from the training transcripts (word ids as
    tokens).  Every bigram over the closed vocabulary is explicit (add-k
    smoothed), so no backoff mass is ever consulted."""
    V = [str(w) for w in range(1, n_words + 1)]
    uni = {w: 0 for w in V + ["</s>"]}
    bi = {}
    for ws in transcripts:
        seq = [str(w) for w in ws]
        prev = "<s>"
        for w in seq + ["</s>"]:
            uni[w] += 1
            bi[(prev, w)] = bi.get((prev, w), 0) + 1
            prev = w
    N = sum(uni.values())
    ctxs = ["<s>"] + V
    ctx_tot = {c: 0 for c in ctxs}
    for (c, w), n in bi.items():
        ctx_tot[c] += n
    lines = ["\\data\\", f"ngram 1={len(V) + 2}",
             f"ngram 2={len(ctxs) * (len(V) + 1)}", "", "\\1-grams:",
             "-99\t<s>\t0"]
    for w in V + ["</s>"]:
        p = (uni[w] + k) / (N + k * (len(V) + 1))
        lines.append(f"{math.log10(p):.6f}\t{w}"
                     + ("\t0" if w != "</s>" else ""))
    lines += ["", "\\2-grams:"]
    for c in ctxs:
        for w in V + ["</s>"]:
            p = ((bi.get((c, w), 0) + k)
                 / (ctx_tot[c] + k * (len(V) + 1)))
            lines.append(f"{math.log10(p):.6f}\t{c} {w}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def bigram_den_fst(phones: int):
    """Ergodic phone bigram: any pdf sequence is a den path, so the
    numerator is always a subset and objf/frame stays <= 0."""
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    states = [FstState() for _ in range(phones + 1)]   # 0 = start hub
    for p in range(phones):
        states[0].arcs.append(FstArc(p + 1, 0.0, p + 1))
        for q in range(phones):
            states[p + 1].arcs.append(FstArc(q + 1, 0.0, q + 1))
        states[p + 1].final = 0.0
    return Fst(start=0, states=states)


def word_loop_fst(lex):
    """Epsilon-free word loop: from the hub each word enters on its first
    phone (olabel = word), each phone state self-loops (duration >= 1),
    word-final states fan out to every word's entry arc and are final.
    Every arc consumes a pdf, so the device decoders take it as is."""
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    states = [FstState()]                 # 0 = start hub
    entry = {}                            # w -> (first pdf label, first state)
    last = {}                             # w -> word-final state id
    for w, phones in lex.items():
        ids = []
        for _ in phones:
            states.append(FstState())
            ids.append(len(states) - 1)
        for j in range(len(phones)):
            states[ids[j]].arcs.append(        # self-loop: stay in phone
                FstArc(phones[j] + 1, 0.0, ids[j], olabel=0))
            if j + 1 < len(phones):            # advance to next phone
                states[ids[j]].arcs.append(
                    FstArc(phones[j + 1] + 1, 0.0, ids[j + 1], olabel=0))
        entry[w] = (phones[0] + 1, ids[0])
        last[w] = ids[-1]
        states[last[w]].final = 0.0
    for w in lex:                              # word entries from the hub
        lbl, st = entry[w]
        states[0].arcs.append(FstArc(lbl, 0.0, st, olabel=w))
    for w_from in lex:                         # word -> next word
        for w_to in lex:
            lbl, st = entry[w_to]
            states[last[w_from]].arcs.append(
                FstArc(lbl, 0.0, st, olabel=w_to))
    return Fst(start=0, states=states)


def acoustic(net, feats, fps: int):
    """The JAX tool's jitted `acoustic` (tools/synthwer.py:346-351): the
    network's fp32 forward, no gradient, at the fps supervision frames ->
    loglikes [b, fps, P]."""
    from kaldi_fp16_tpu_torch.models.network import subsample_output
    with torch.no_grad():
        outs, _ = net(feats, None, train=False, compute_dtype=torch.float32)
    return subsample_output(outs[net.model.chain_output().name], STRIDE,
                            LEFT, fps)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.synthwer")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--phones", type=int, default=12)
    ap.add_argument("--words", type=int, default=6)
    ap.add_argument("--phones-per-word", dest="ppw", type=int, default=2)
    ap.add_argument("--dur", type=int, default=2)
    ap.add_argument("--max-dur", type=int, default=0,
                    help="> --dur: per-phone durations drawn uniformly "
                         "from [dur, max-dur] — variable utterance "
                         "lengths (bucketed batching, flexible decode)")
    ap.add_argument("--words-per-utt", type=int, default=3)
    ap.add_argument("--feat-dim", type=int, default=24)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--train-utts", type=int, default=384)
    ap.add_argument("--test-utts", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--final-lr", type=float, default=0.003)
    ap.add_argument("--l2", type=float, default=1e-3,
                    help="chain output l2 (keeps logits bounded once the "
                         "classes separate — Kaldi l2-regularize)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--acoustic-scale", type=float, default=1.0)
    ap.add_argument("--ambiguous", action="store_true",
                    help="words may share phones (segmentation ambiguity: "
                         "0%% WER not guaranteed without an LM)")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="word-frequency skew (p ~ rank^-zipf; 0 = "
                         "uniform) — gives the rescoring LM real signal")
    ap.add_argument("--lm-rescore", action="store_true",
                    help="after training: decode exact device lattices, "
                         "rescore with a bigram ARPA LM estimated from "
                         "the TRAIN transcripts, compare WER")
    ap.add_argument("--lm-weight", type=float, default=1.0)
    ap.add_argument("--lattice-beam", type=float, default=8.0)
    ap.add_argument("--streaming", action="store_true",
                    help="after training: ALSO decode through the "
                         "windowed streaming decoder (chunked feeds, "
                         "bounded backpointer window) and score its WER")
    ap.add_argument("--stream-chunk", type=int, default=6)
    ap.add_argument("--stream-window", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from kaldi_fp16_tpu_torch.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu_torch.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu_torch.decode.device_viterbi import (
        SparseViterbiDecoder,
    )
    from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
    from kaldi_fp16_tpu_torch.decode.wer import wer
    from kaldi_fp16_tpu_torch.device import resolve_device
    from kaldi_fp16_tpu_torch.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu_torch.io.egs import write_ark
    from kaldi_fp16_tpu_torch.models.model import build_model_from_string
    from kaldi_fp16_tpu_torch.training.train_step import TrainConfig
    from kaldi_fp16_tpu_torch.training.trainer import Trainer, exponential_lr

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.train_utts < args.batch:
        raise SystemExit(f"--train-utts {args.train_utts} < --batch "
                         f"{args.batch}: the loader would never yield a "
                         f"full batch (drop_remainder)")
    rng = np.random.default_rng(args.seed)
    lex = make_lexicon(rng, args.phones, args.words, args.ppw,
                       disjoint=not args.ambiguous)
    means = rng.normal(size=(args.phones, args.feat_dim)).astype(
        np.float32) * 1.5

    with tempfile.TemporaryDirectory(prefix="synthwer_") as workdir:
        # -- data -------------------------------------------------------
        train_pairs = [make_example(rng, f"tr-{i:04d}", lex, args, means)
                       for i in range(args.train_utts)]
        train_exs = [ex for ex, _ in train_pairs]
        train_refs = [ws for _, ws in train_pairs]
        half = len(train_exs) // 2
        write_ark(os.path.join(workdir, "cegs.1.ark"), train_exs[:half])
        write_ark(os.path.join(workdir, "cegs.2.ark"), train_exs[half:])
        test = [make_example(rng, f"te-{i:04d}", lex, args, means)
                for i in range(args.test_utts)]
        test_refs = [ws for _, ws in test]
        # group test utts by length (durations may vary with --max-dur);
        # each group decodes as one batch, results land back in test order
        groups = {}
        for i, (ex, _) in enumerate(test):
            groups.setdefault(ex.supervision.frames_per_seq, []).append(i)
        test_groups = [
            (idx, torch.from_numpy(np.stack(
                [test[i][0].inputs[0].data for i in idx])).to(device), f)
            for f, idx in sorted(groups.items())]

        # -- model + trainer ----------------------------------------------
        # The JAX tool also passes fst_pad_states / fst_pad_arcs: they pad
        # the numerator graphs to static shapes so XLA compiles one step
        # per length, and leave the objective unchanged.  The port's
        # Trainer takes each batch's graph at its own size.
        model = build_model_from_string(
            build_xconfig(args.feat_dim, args.phones))
        den = DenominatorComputation(DenominatorGraph.from_fst(
            bigram_den_fst(args.phones), args.phones), leaky=1e-4,
            device=device)
        config = TrainConfig(learning_rate=args.lr, momentum=0.5,
                             frame_subsampling_factor=STRIDE,
                             xent_regularize=0.0, compute_dtype="float32")
        trainer = Trainer(model, den, config,
                          ChainTrainingOpts(l2_regularize=args.l2),
                          lr_schedule=exponential_lr(args.lr, args.final_lr,
                                                     args.steps),
                          seed=args.seed, device=device)

        # -- decoder over the word loop -----------------------------------
        loop = DecodingGraph.from_fst(word_loop_fst(lex))
        dec = SparseViterbiDecoder(loop, acoustic_scale=args.acoustic_scale,
                                   device=device)

        def posteriors_by_group():
            """-> [(test indices, loglikes [b, fps, P] fp32 on the
            device)] per length group."""
            return [(idx, acoustic(trainer.net, feats, f))
                    for idx, feats, f in test_groups]

        def eval_wer():
            hyps = [None] * len(test_refs)
            for idx, ll in posteriors_by_group():
                for i, r in zip(idx, dec.decode_batch(ll)):
                    hyps[i] = r["words"]
            return wer(test_refs, hyps)

        def loader():
            return DataLoader(os.path.join(workdir, "cegs.*.ark"),
                              DataLoaderConfig(batch_size=args.batch,
                                               feat_dim=args.feat_dim,
                                               label_dim=args.phones,
                                               shuffle_files=True,
                                               shuffle_buffer=256,
                                               seed=args.seed))

        history = []
        report = eval_wer()
        history.append({"step": 0, **report})
        print(json.dumps(history[-1]), flush=True)
        steps = 0
        while steps < args.steps:
            made_progress = False
            for batch in loader():
                made_progress = True
                out = trainer.train_batch(batch)
                steps += 1
                if steps % args.eval_every == 0 or steps >= args.steps:
                    report = eval_wer()
                    history.append({
                        "step": steps,
                        "objf": round(float(out.objf_per_frame), 4),
                        **{k: round(v, 4) for k, v in report.items()}})
                    print(json.dumps(history[-1]), flush=True)
                if steps >= args.steps:
                    break
            if not made_progress:
                raise SystemExit("the data never filled one homogeneous "
                                 "batch — lower --batch or raise "
                                 "--train-utts")

        streamed = None
        if args.streaming:
            from kaldi_fp16_tpu_torch.decode.streaming import (
                WindowedStreamingDecoder,
            )
            sdec = WindowedStreamingDecoder(
                loop, acoustic_scale=args.acoustic_scale,
                window=args.stream_window, device=device)
            hyps_s = [None] * len(test_refs)
            C = args.stream_chunk
            for idx, ll in posteriors_by_group():
                st = sdec.init(batch=ll.shape[0])
                for c0 in range(0, ll.shape[1], C):
                    st = sdec.feed(st, ll[:, c0:c0 + C])
                for i, r in zip(idx, sdec.finalize(st)):
                    hyps_s[i] = r["words"]
            streamed = {"streaming_wer": wer(test_refs, hyps_s)["wer"],
                        "chunk": C, "window": args.stream_window}
            print(json.dumps({"streaming": streamed}), flush=True)

        rescored = None
        if args.lm_rescore:
            from kaldi_fp16_tpu_torch.decode.device_viterbi import (
                DeviceLatticeDecoder,
            )
            from kaldi_fp16_tpu_torch.decode.lattice import rescore_with_lm
            from kaldi_fp16_tpu_torch.decode.lm import read_arpa
            arpa = os.path.join(workdir, "bigram.arpa")
            write_arpa(arpa, train_refs, len(lex))
            lm, syms = read_arpa(arpa, {str(w): w for w in lex})
            ldec = DeviceLatticeDecoder(loop,
                                        acoustic_scale=args.acoustic_scale,
                                        lattice_beam=args.lattice_beam,
                                        device=device)
            hyps_v = [None] * len(test_refs)
            hyps_r = [None] * len(test_refs)
            for idx, ll in posteriors_by_group():
                for i, lat in zip(idx, ldec.decode_batch(ll)):
                    w0, _ = lat.best_path(acoustic_scale=args.acoustic_scale)
                    rlat = rescore_with_lm(lat, lm, lm_weight=args.lm_weight,
                                           old_lm_weight=1.0,
                                           eos=syms["</s>"])
                    w1, _ = rlat.best_path(
                        acoustic_scale=args.acoustic_scale)
                    hyps_v[i] = w0
                    hyps_r[i] = w1
            rescored = {"lattice_viterbi_wer": wer(test_refs, hyps_v)["wer"],
                        "lm_rescored_wer": wer(test_refs, hyps_r)["wer"]}
            print(json.dumps({"lm_rescore": rescored}), flush=True)

    first, final = history[0]["wer"], history[-1]["wer"]
    ok = final < first and final <= 0.05
    if streamed is not None:
        # the online path must match the offline result it is contracted
        # to (traceback-delay commits; see decode/streaming.py)
        ok = ok and streamed["streaming_wer"] <= max(final, 0.05)
    if rescored is not None:
        # rescoring must not WORSEN the converged result: a broken
        # lattice/ARPA path fails the gate instead of hiding behind the
        # Viterbi number
        ok = ok and rescored["lm_rescored_wer"] <= max(final, 0.05)
    out = {"ok": bool(ok), "wer_first": first, "wer_final": final,
           "steps": steps, "lexicon_words": len(lex),
           "test_utts": args.test_utts}
    if rescored is not None:
        out["wer_rescored"] = rescored["lm_rescored_wer"]
    if streamed is not None:
        out["wer_streaming"] = streamed["streaming_wer"]
    print(json.dumps(out), flush=True)
    return {**out, "history": history, "streaming": streamed,
            "lm_rescore": rescored, "trainer": trainer}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
