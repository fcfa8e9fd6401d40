"""Task metrics the port uses: Levenshtein distance for WER and corpus
BLEU (the port's copy of the two functions of
``openseq2seq_tpu/utils/metrics.py``; reference
``open_seq2seq/models/speech2text.py:51-97`` and
``models/text2text.py:42-55``)."""
from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Sequence


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (tokens or chars)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1,          # deletion
                           cur[j - 1] + 1,       # insertion
                           prev[j - 1] + (ca != cb)))  # substitution
        prev = cur
    return prev[-1]


def _ngram_counts(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(references: Iterable[List[str]],
                hypotheses: Iterable[List[str]],
                max_n: int = 4,
                smooth: bool = False) -> float:
    """Corpus-level BLEU with uniform n-gram weights, brevity penalty
    and clipped counts (nltk's corpus_bleu without the dependency)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    ref_len = 0
    hyp_len = 0
    for ref, hyp in zip(references, hypotheses):
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            ref_counts = _ngram_counts(ref, n)
            hyp_counts = _ngram_counts(hyp, n)
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            for gram, cnt in hyp_counts.items():
                clipped[n - 1] += min(cnt, ref_counts.get(gram, 0))
    if hyp_len == 0:
        return 0.0
    log_prec = 0.0
    for n in range(max_n):
        num, den = clipped[n], totals[n]
        if smooth:
            num, den = num + 1, den + 1
        if num == 0 or den == 0:
            return 0.0
        log_prec += math.log(num / den) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / hyp_len)
    return bp * math.exp(log_prec)
