"""Viterbi beam-search decoder over WFST decoding graphs.

Classic hybrid-ASR token passing (Kaldi decoder/faster-decoder.cc
semantics, reimplemented from scratch):

  per frame: for each active token, expand emitting arcs with cost
    graph_weight + acoustic_scale * (-loglike[pdf]), keep the best token per
    destination state; then expand epsilon arcs to closure; prune by beam
    (best + beam) and max_active (cap the active set).
  termination: add final costs; backtrace the best token's arc chain,
  collecting output labels (words).

This CPU implementation is the correctness oracle; the batched device
decoders (device_viterbi.py) layer on top (posteriors are computed
on-device; graphs live on host).

Copy of kaldi_fp16_tpu/decode/viterbi.py (the port imports nothing of
the JAX package); tests/test_torch_decode_host.py holds the two equal.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph


@dataclass(frozen=True)
class DecodeOptions:
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 1.0


@dataclass
class DecodeResult:
    words: List[int]
    alignment: List[int]       # per-frame ilabels on the best path
    total_cost: float
    final_reached: bool
    frames: int


class _Token:
    __slots__ = ("cost", "back", "olabel", "ilabel")

    def __init__(self, cost: float, back: Optional["_Token"], olabel: int,
                 ilabel: int):
        self.cost = cost
        self.back = back
        self.olabel = olabel
        self.ilabel = ilabel


class ViterbiDecoder:
    def __init__(self, graph: DecodingGraph,
                 opts: DecodeOptions = DecodeOptions()):
        self.graph = graph
        self.opts = opts

    # -- helpers ------------------------------------------------------------

    def _eps_closure(self, tokens: Dict[int, _Token]) -> None:
        """Expand epsilon arcs until fixpoint (cost-improving only)."""
        g = self.graph
        heap = [(t.cost, s) for s, t in tokens.items()]
        heapq.heapify(heap)
        while heap:
            cost, s = heapq.heappop(heap)
            tok = tokens.get(s)
            if tok is None or tok.cost < cost - 1e-12:
                continue
            for a in range(g.eps_row_ptr[s], g.eps_row_ptr[s + 1]):
                d = int(g.eps_dst[a])
                new_cost = cost + float(g.eps_weight[a])
                cur = tokens.get(d)
                if cur is None or new_cost < cur.cost:
                    tokens[d] = _Token(new_cost, tok, int(g.eps_olabel[a]), 0)
                    heapq.heappush(heap, (new_cost, d))

    def _prune(self, tokens: Dict[int, _Token]) -> Dict[int, _Token]:
        if not tokens:
            return tokens
        best = min(t.cost for t in tokens.values())
        cutoff = best + self.opts.beam
        kept = {s: t for s, t in tokens.items() if t.cost <= cutoff}
        if len(kept) > self.opts.max_active:
            costs = sorted(t.cost for t in kept.values())
            cutoff = costs[self.opts.max_active - 1]
            kept = {s: t for s, t in kept.items() if t.cost <= cutoff}
        return kept

    # -- decode -------------------------------------------------------------

    def decode(self, loglikes: np.ndarray) -> DecodeResult:
        """loglikes: [T, P] acoustic log-likelihoods (e.g. chain output)."""
        g = self.graph
        opts = self.opts
        T = loglikes.shape[0]

        tokens: Dict[int, _Token] = {g.start: _Token(0.0, None, 0, 0)}
        self._eps_closure(tokens)
        tokens = self._prune(tokens)

        for t in range(T):
            frame = loglikes[t]
            nxt: Dict[int, _Token] = {}
            for s, tok in tokens.items():
                for a in range(g.em_row_ptr[s], g.em_row_ptr[s + 1]):
                    il = int(g.em_ilabel[a])
                    pdf = g.pdf_of(il)
                    ac = -opts.acoustic_scale * float(frame[pdf])
                    new_cost = tok.cost + float(g.em_weight[a]) + ac
                    d = int(g.em_dst[a])
                    cur = nxt.get(d)
                    if cur is None or new_cost < cur.cost:
                        nxt[d] = _Token(new_cost, tok, int(g.em_olabel[a]), il)
            self._eps_closure(nxt)
            tokens = self._prune(nxt)
            if not tokens:
                break

        # termination: add final costs
        best_tok: Optional[_Token] = None
        best_cost = np.inf
        final_reached = False
        for s, tok in tokens.items():
            fc = g.final_cost[s]
            if np.isfinite(fc):
                c = tok.cost + float(fc)
                if c < best_cost:
                    best_cost, best_tok, final_reached = c, tok, True
        if best_tok is None:
            for s, tok in tokens.items():  # fall back to best non-final
                if tok.cost < best_cost:
                    best_cost, best_tok = tok.cost, tok

        words: List[int] = []
        alignment: List[int] = []
        cur = best_tok
        while cur is not None:
            if cur.olabel > 0:
                words.append(cur.olabel)
            if cur.ilabel > 0:
                alignment.append(cur.ilabel)
            cur = cur.back
        words.reverse()
        alignment.reverse()
        return DecodeResult(words=words, alignment=alignment,
                            total_cost=float(best_cost),
                            final_reached=final_reached, frames=T)

    def decode_batch(self, loglikes: np.ndarray) -> List[DecodeResult]:
        """loglikes: [B, T, P]."""
        return [self.decode(loglikes[b]) for b in range(loglikes.shape[0])]
