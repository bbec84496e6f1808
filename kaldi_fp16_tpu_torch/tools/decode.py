"""decode: end-to-end decoding on PyTorch: egs -> acoustic model ->
posteriors -> WFST lattice decode -> (optional LM rescoring) -> words +
WER.

The twin of tools/decode.py.  It takes the same flags, with these
differences:

  --device    where the network and the --on-device decoders run
              (default: the current CUDA device); it replaces --cpu
  --model     a Kaldi model file (binary .mdl / .raw or nnet3 text) is
              loaded into the network --xconfig builds
              (models/kaldi_loader.load_into_network), as the JAX tool
              does; without --egs, --graph and --xconfig it is an error
              (the JAX tool ignores it in demo mode)

Usage:
  python -m kaldi_fp16_tpu_torch.tools.decode --egs 'data/cegs.*.ark' \\
      --xconfig cfg --pdfs P --graph HCLG.fst [--model final.mdl] \\
      [--acoustic-scale 1.0] \\
      [--beam 16] [--lattice-beam 8] [--ref ref.txt] [--nbest 0] \\
      [--on-device]

With no --egs/--graph/--xconfig it runs a synthetic demo (a 2-word graph).
`--ref` is a text file "utt-key word-id word-id ..." for WER scoring.  The
network's weights are --model's, else random from seed 0.  `--on-device`
decodes batched and exact on the device (decode/device_viterbi.py):
Viterbi, or lattices when --nbest, --arpa-lm or --ctm is given; without
it the host token-passing LatticeDecoder runs.

`main(argv)` returns {"hyps": {key: words}, "final_reached": {key: bool},
"wer": the WER report or None}.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m kaldi_fp16_tpu_torch.tools.decode")
    ap.add_argument("--egs")
    ap.add_argument("--graph")
    ap.add_argument("--xconfig")
    ap.add_argument("--model",
                    help="Kaldi model to load (binary .mdl/.raw or text)")
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--acoustic-scale", type=float, default=1.0)
    ap.add_argument("--beam", type=float, default=16.0)
    ap.add_argument("--lattice-beam", type=float, default=8.0)
    ap.add_argument("--ref", help="reference transcripts for WER")
    ap.add_argument("--nbest", type=int, default=0)
    ap.add_argument("--arpa-lm", help="ARPA LM for lattice rescoring")
    ap.add_argument("--words", help="words.txt symbol table for the LM")
    ap.add_argument("--lm-weight", type=float, default=1.0)
    ap.add_argument("--old-lm-weight", type=float, default=0.0,
                    help="weight on the graph's own scores when rescoring")
    ap.add_argument("--ctm", help="write best-path word timings + "
                    "confidences (lattice posteriors) as CTM to this "
                    "path (lattice modes only)")
    ap.add_argument("--frame-shift", type=float, default=0.03,
                    help="seconds per OUTPUT frame for CTM times "
                         "(0.01 input shift x subsampling 3)")
    ap.add_argument("--on-device", action="store_true",
                    help="batched exact decode on the device (arc-parallel, "
                         "epsilon-free graphs); with --nbest/--arpa-lm/--ctm "
                         "the device emits exact beam-pruned lattices "
                         "(alpha+arc+beta criterion) and n-best/rescoring "
                         "run on them")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def two_word_graph():
    """Graph accepting word 1 = pdfs [1,2] or word 2 = pdfs [3,4], then
    optional epsilon back to start (so sequences of words decode); a copy
    of tests/test_decoder.py's."""
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    s = [FstState() for _ in range(5)]
    s[0].arcs.append(FstArc(1, 0.0, 1, olabel=0))
    s[1].arcs.append(FstArc(2, 0.0, 4, olabel=1))
    s[0].arcs.append(FstArc(3, 0.0, 2, olabel=0))
    s[2].arcs.append(FstArc(4, 0.0, 4, olabel=2))
    s[4].arcs.append(FstArc(0, 0.1, 0, olabel=0))
    s[4].final = 0.0
    return Fst(start=0, states=s)


def eps_free_graph():
    """two_word_graph with an emitting loop-back, for the device decoders;
    a copy of tests/test_tpu_viterbi.py's."""
    from kaldi_fp16_tpu_torch.io.fst import Fst, FstArc, FstState
    s = [FstState() for _ in range(5)]
    s[0].arcs.append(FstArc(1, 0.0, 1, olabel=0))
    s[1].arcs.append(FstArc(2, 0.0, 4, olabel=1))
    s[0].arcs.append(FstArc(3, 0.0, 2, olabel=0))
    s[2].arcs.append(FstArc(4, 0.0, 4, olabel=2))
    s[4].arcs.append(FstArc(1, 0.1, 1, olabel=0))
    s[4].arcs.append(FstArc(3, 0.1, 2, olabel=0))
    s[4].final = 0.0
    return Fst(start=0, states=s)


def loglikes_for(pdf_seq, num_pdfs=6, good=5.0, bad=0.0):
    """[T, P] loglikes strongly favoring pdf_seq (1-indexed pdfs); a copy
    of tests/test_decoder.py's."""
    ll = np.full((len(pdf_seq), num_pdfs), bad, dtype=np.float64)
    for t, p in enumerate(pdf_seq):
        ll[t, p - 1] = good
    return ll


def acoustic_posteriors(net, loader, device) -> Dict[str, torch.Tensor]:
    """{utterance key: [T_out, P] float32 on `device`}: the network's
    chain output (train=False) at the supervision frames of each egs
    batch from `loader`."""
    from kaldi_fp16_tpu_torch.models.network import subsample_output
    name = net.model.chain_output().name
    posts = {}
    with torch.no_grad():
        for batch in loader:
            ivecs = (None if batch.ivectors is None
                     else torch.from_numpy(batch.ivectors).to(device))
            outs, _ = net(torch.from_numpy(batch.features).to(device), ivecs,
                          train=False)
            out = subsample_output(outs[name], 3, batch.left_context,
                                   batch.frames_per_seq)
            for i, key in enumerate(batch.keys):
                posts[key] = out[i]
    return posts


def _host(ll) -> np.ndarray:
    """[T, P] loglikes as the host decoders take them (float64 numpy)."""
    if isinstance(ll, torch.Tensor):
        return ll.cpu().numpy().astype(np.float64)
    return ll


def main(argv=None) -> dict:
    args = parse_args(argv)
    demo = not (args.egs and args.graph and args.xconfig)
    if args.model and demo:
        raise SystemExit("--model needs --egs, --graph and --xconfig: its "
                         "weights go into the network --xconfig builds")
    from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
    from kaldi_fp16_tpu_torch.decode.lattice import (
        LatticeDecodeOptions, LatticeDecoder, rescore_with_lm,
    )
    from kaldi_fp16_tpu_torch.decode.wer import wer
    from kaldi_fp16_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if demo:
        print("demo mode: synthetic graph + posteriors "
              "(pass --egs/--graph/--xconfig for real decoding)")
        graph = DecodingGraph.from_fst(eps_free_graph() if args.on_device
                                       else two_word_graph())
        posts = {"demo-utt": loglikes_for([1, 2, 3, 4])}
        refs = {"demo-utt": [1, 2]}
    else:
        from kaldi_fp16_tpu_torch.io.dataloader import (
            DataLoader, DataLoaderConfig,
        )
        from kaldi_fp16_tpu_torch.models.model import build_model
        from kaldi_fp16_tpu_torch.models.network import Network
        graph = DecodingGraph.from_file(args.graph)
        net = Network(build_model(args.xconfig),
                      torch.Generator(device=device).manual_seed(0), device)
        if args.model:
            from kaldi_fp16_tpu_torch.models.kaldi_loader import (
                load_into_network,
            )
            load_into_network(net, args.model)
        net.eval()
        posts = acoustic_posteriors(
            net, DataLoader(args.egs, DataLoaderConfig(
                batch_size=args.batch, label_dim=args.pdfs)), device)
        refs = {}
        if args.ref:
            with open(args.ref) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        refs[parts[0]] = [int(w) for w in parts[1:]]

    lm = None
    if args.arpa_lm:
        from kaldi_fp16_tpu_torch.decode.lm import read_arpa, read_symbol_table
        syms = read_symbol_table(args.words) if args.words else None
        lm, _ = read_arpa(args.arpa_lm, syms)
        print(f"ARPA LM loaded: order {lm.order}, {len(lm.ngrams)} n-grams")

    hyps, reached, ref_list, hyp_list = {}, {}, [], []
    ctm_f = open(args.ctm, "w") if args.ctm else None

    def emit_ctm(key, lat):
        """Kaldi-format CTM: key channel start dur word [conf]."""
        if ctm_f is None:
            return
        for start, dur, w, conf in lat.to_ctm(
                frame_shift=args.frame_shift,
                acoustic_scale=args.acoustic_scale):
            ctm_f.write(f"{key} 1 {start:.3f} {dur:.3f} {w} {conf:.3f}\n")

    def lattice_result(key, lat, where):
        if lm is not None:
            lat = rescore_with_lm(lat, lm, lm_weight=args.lm_weight,
                                  old_lm_weight=args.old_lm_weight)
        words, cost = lat.best_path(acoustic_scale=args.acoustic_scale)
        hyps[key], reached[key] = words, bool(np.isfinite(cost))
        emit_ctm(key, lat)
        extra = ""
        if args.nbest:
            nb = lat.n_best(args.nbest, acoustic_scale=args.acoustic_scale)
            extra = "  nbest=" + "; ".join(f"{w}@{c:.2f}" for w, c in nb)
        print(f"{key}: {' '.join(map(str, words))}  (cost {cost:.3f}, "
              f"{len(lat.arcs)} lattice arcs{where}){extra}")

    try:
        if args.on_device:
            # batched exact decode on the device, grouped by frame count so
            # every group is one [B, T, P] batch (no padding frames that
            # would alter paths).  Plain Viterbi unless lattices are needed.
            from kaldi_fp16_tpu_torch.decode import device_viterbi
            if len(graph.eps_dst):
                from kaldi_fp16_tpu_torch.decode.graph import remove_epsilons
                print(f"epsilon-removing the graph for on-device decode "
                      f"({len(graph.eps_dst)} eps arcs)")
                graph = remove_epsilons(graph)
            want_lattice = bool(args.nbest or args.arpa_lm or args.ctm)
            if want_lattice:
                dec = device_viterbi.DeviceLatticeDecoder(
                    graph, acoustic_scale=args.acoustic_scale,
                    lattice_beam=args.lattice_beam, device=device)
            else:
                dec = device_viterbi.SparseViterbiDecoder(
                    graph, acoustic_scale=args.acoustic_scale, device=device)
            by_t = {}
            for key, ll in posts.items():
                by_t.setdefault(ll.shape[0], []).append((key, ll))
            for _, group in sorted(by_t.items()):
                lls = [ll for _, ll in group]
                lls = (torch.stack(lls) if isinstance(lls[0], torch.Tensor)
                       else np.stack(lls))
                results = dec.decode_batch(lls)
                for (key, _), res in zip(group, results):
                    if want_lattice:
                        lattice_result(key, res, ", on-device")
                    else:
                        hyps[key] = res["words"]
                        reached[key] = res["final_reached"]
                        print(f"{key}: {' '.join(map(str, res['words']))}  "
                              f"(cost {res['total_cost']:.3f}, on-device)")
        else:
            dec = LatticeDecoder(graph, LatticeDecodeOptions(
                beam=args.beam, lattice_beam=args.lattice_beam,
                acoustic_scale=args.acoustic_scale))
            for key, ll in posts.items():
                lattice_result(key, dec.decode(_host(ll)), "")
    finally:
        if ctm_f:
            ctm_f.close()
    for key, words in hyps.items():
        if key in refs:
            ref_list.append(refs[key])
            hyp_list.append(words)
    report = None
    if ref_list:
        report = wer(ref_list, hyp_list)
        print("WER: " + " ".join(f"{k}={v}" for k, v in report.items()))
    if ctm_f:
        print(f"wrote CTM: {args.ctm}")
    return {"hyps": hyps, "final_reached": reached, "wer": report}


if __name__ == "__main__":
    main()
