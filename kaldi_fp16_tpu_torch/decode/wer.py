"""Word-error-rate scoring (levenshtein alignment).

Copy of kaldi_fp16_tpu/decode/wer.py (the port imports nothing of
the JAX package); tests/test_torch_decode_host.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def levenshtein(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Returns (substitutions, insertions, deletions, edits)."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels)
    dp = np.zeros((R + 1, H + 1), dtype=np.int64)
    dp[:, 0] = np.arange(R + 1)
    dp[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dele = dp[i - 1, j] + 1
            ins = dp[i, j - 1] + 1
            dp[i, j] = min(sub, dele, ins)
    # backtrace for counts
    i, j = R, H
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, ins, dels, subs + ins + dels


def wer(refs: List[Sequence], hyps: List[Sequence]) -> Dict[str, float]:
    """Corpus WER over paired reference/hypothesis word sequences."""
    assert len(refs) == len(hyps)
    total_subs = total_ins = total_dels = total_words = 0
    for r, h in zip(refs, hyps):
        s, i, d, _ = levenshtein(r, h)
        total_subs += s
        total_ins += i
        total_dels += d
        total_words += len(r)
    edits = total_subs + total_ins + total_dels
    return {
        "wer": 100.0 * edits / max(total_words, 1),
        "substitutions": total_subs,
        "insertions": total_ins,
        "deletions": total_dels,
        "ref_words": total_words,
    }
