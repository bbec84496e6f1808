"""ARPA n-gram LM reader + Kaldi symbol tables for lattice rescoring.

Reads standard ARPA text (SRILM/KenLM `\\data\\ ... \\N-grams: ... \\end\\`,
log10 probabilities) into the `NGramLM` cost tables used by
decode/lattice.rescore_with_lm; words are mapped to ids through a Kaldi
`words.txt` symbol table (or an auto-built one).  Costs are natural-log
(-ln p), Kaldi/OpenFst convention.

Copy of kaldi_fp16_tpu/decode/lm.py (the port imports nothing of
the JAX package); tests/test_torch_decode_host.py holds the two equal.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, Optional, Tuple

from kaldi_fp16_tpu_torch.decode.lattice import NGramLM

_LN10 = math.log(10.0)


def read_symbol_table(path: str) -> Dict[str, int]:
    """Kaldi words.txt: lines of '<word> <id>'."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def read_arpa(path: str, symbols: Optional[Dict[str, int]] = None,
              oov_cost: float = 20.0) -> Tuple[NGramLM, Dict[str, int]]:
    """Parse an ARPA file (optionally gzipped) into an NGramLM.

    Words missing from `symbols` are assigned fresh ids (starting past the
    table's max); returns (lm, symbols) with the final mapping.  <s>/</s>
    participate in contexts via their ids like any word; epsilon (id 0) is
    never produced by lattice arcs so it is safe as a non-word.
    """
    symbols = dict(symbols) if symbols else {}
    next_id = max(symbols.values(), default=0) + 1

    def wid(word: str) -> int:
        nonlocal next_id
        if word not in symbols:
            symbols[word] = next_id
            next_id += 1
        return symbols[word]

    ngrams: Dict[tuple, float] = {}
    backoffs: Dict[tuple, float] = {}
    order = 1
    cur_n = 0

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        section = None
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("\\") :
                low = line.lower()
                if low == "\\data\\":
                    section = "data"
                elif low.endswith("-grams:"):
                    cur_n = int(line[1:].split("-")[0])
                    order = max(order, cur_n)
                    section = "ngrams"
                elif low == "\\end\\":
                    break
                continue
            if section == "data":
                continue  # 'ngram N=count' lines
            if section != "ngrams" or cur_n == 0:
                continue
            parts = line.split()
            # logprob w1 ... wn [backoff]
            if len(parts) < 1 + cur_n:
                continue
            logp = float(parts[0])
            words = tuple(wid(w) for w in parts[1:1 + cur_n])
            ngrams[words] = -logp * _LN10
            if len(parts) > 1 + cur_n:
                try:
                    bo = float(parts[1 + cur_n])
                except ValueError:
                    continue
                backoffs[words] = -bo * _LN10

    return NGramLM(ngrams, backoffs, order=order, oov_cost=oov_cost), symbols


def sentence_cost(lm: NGramLM, word_ids, bos: Optional[int] = None,
                  eos: Optional[int] = None) -> float:
    """Total -ln P(sentence): standard <s> context / </s> termination."""
    ctx = (bos,) if bos is not None else ()
    total = 0.0
    for w in word_ids:
        total += lm.cost(ctx, w)
        ctx = (ctx + (w,))[-(lm.order - 1):] if lm.order > 1 else ()
    if eos is not None:
        total += lm.cost(ctx, eos)
    return total
