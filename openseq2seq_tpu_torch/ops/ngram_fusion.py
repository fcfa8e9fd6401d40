"""Dense n-gram LM tables for on-device shallow fusion (the port's copy
of ``openseq2seq_tpu/ops/ngram_fusion.py``, unchanged in behaviour; the
table is built once on the host, and the transducer decoder moves it to
the model's device).

Shallow fusion adds lambda * log P_lm(y_i | history) to every label
expansion of a beam search. CPU/GPU decoders (the reference's
`decoders/scorer.cpp` KenLM scorer) do this with hash-table lookups per
hypothesis — data-dependent host work. For *label-level* LMs (characters
or small subword sets, the granularity transducer recipes decode at) the
entire conditional distribution fits in device memory as a dense table:

    table[ctx, w] = ln P(w | ctx)        (C**m rows, L columns)

where L = #labels, C = L + 1 (symbol L is the BOS/empty pad), and
m = order - 1 context positions. A beam hypothesis's LM state is then
ONE int32 — the base-C rolling encoding of its last m labels — and the
per-step fusion cost inside the decode loop is a single gather plus an
integer divide/multiply-add to advance the context. Static shapes,
no host round-trips, O(1) per expansion regardless of LM order.

Size stays trivial at character granularity: a 29-char English alphabet
at order 3 is 841 x 28 floats (~94 KB); order 4 is ~2.7 MB. Word-level
LMs do NOT fit this scheme (C**m explodes) — those go through the
host-side n-best rescoring path instead (the JAX package's
`apps/lm_rescorer.py`, not ported yet).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

from .arpa_lm import ArpaLM

_LN10 = math.log(10.0)
BOS = "<s>"
SP = "<sp>"   # ARPA tokens are whitespace-delimited — a literal-space
              # label is escaped as <sp> in LM files (both directions:
              # build_label_lm writes it, dense_label_lm queries it)


@functools.lru_cache(maxsize=8)
def dense_label_lm(arpa_path: str, labels: Tuple[str, ...],
                   order: int = 3
                   ) -> Tuple[np.ndarray, int, int, int]:
    """Densify a label-level ARPA LM into a fusion table.

    Args:
      arpa_path: .arpa text or OS2SLM01 binary (`ops/arpa_lm.py`).
      labels: id-ordered label strings (the decoder's 0..V-2 outputs;
        blank is NOT a label and never scored).
      order: densification order (capped by the LM's own order). The
        table has C**(order-1) rows — keep order <= 4 for char LMs.

    Returns ``(table, C, m, init_ctx)``:
      table: (C**m, L) float32, natural-log P(label | context). Row
        index encodes the last m labels in base C, lowest digit =
        OLDEST symbol; digit value L means BOS/empty (start of
        utterance). Contexts that are unreachable (BOS after a real
        label) are still filled — harmless, never indexed.
      C, m: base and context length, for the rolling update
        ``ctx' = ctx // C + token * C**(m-1)``.
      init_ctx: the all-BOS start context index.
    """
    lm = ArpaLM(arpa_path)
    L = len(labels)
    C = L + 1
    m = max(1, min(order, lm.order) - 1)
    n_ctx = C ** m
    table = np.empty((n_ctx, L), np.float32)
    labels = tuple(SP if c == " " else c for c in labels)
    syms = list(labels) + [BOS]
    for ctx_idx in range(n_ctx):
        digits, r = [], ctx_idx
        for _ in range(m):
            digits.append(r % C)
            r //= C
        # lowest digit oldest -> context tuple reads oldest..newest;
        # leading BOS pads mark "fewer than m labels consumed yet"
        ctx = tuple(syms[d] for d in digits)
        # strip BOS pads except a single sentence-start marker, matching
        # how ArpaLM.sentence_log10 scores the first words of a sentence
        real = tuple(s for s in ctx if s != BOS)
        ctx = ((BOS,) + real) if len(real) < len(ctx) else real
        for w in range(L):
            table[ctx_idx, w] = lm.log10_cond(ctx, labels[w]) * _LN10
    init_ctx = sum(L * C ** i for i in range(m))
    return table, C, m, init_ctx


def build_label_lm(transcripts: Sequence[str], out_path: str,
                   order: int = 3) -> str:
    """Estimate a character-level fusion LM from plain transcripts
    (space escaped as <sp>) and write ARPA — the transducer-decode
    analogue of `scripts/build_lm.py` for the CTC scorer."""
    from .arpa_lm import build_arpa
    sents = [[SP if c == " " else c for c in t] for t in transcripts]
    return build_arpa(sents, out_path, order=order)


def sequence_fusion_score(table: np.ndarray, C: int, m: int,
                          init_ctx: int, ids: Sequence[int]) -> float:
    """Reference scorer (tests/oracles): sum of table lookups for a
    label-id sequence, advancing the rolling context exactly as the
    on-device decode does."""
    ctx, total = init_ctx, 0.0
    for tok in ids:
        total += float(table[ctx, int(tok)])
        ctx = ctx // C + int(tok) * C ** (m - 1)
    return total
