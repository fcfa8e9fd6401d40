"""ARPA-format n-gram language model: loader, scorer, and a small
estimator, ``build_arpa`` (the port's copy of
``openseq2seq_tpu/ops/arpa_lm.py``, unchanged in behaviour; it imports
nothing of JAX). It replaces the KenLM dependency of the reference's
beam decoders (`decoders/scorer.{h,cpp}`, `scripts/build_lm.py`).

The ARPA text format is the interchange format KenLM itself consumes;
scoring follows the standard Katz backoff recursion in log10 space:

  P(w | h) = p(w | h)                      if (h, w) listed
           = backoff(h) * P(w | h[1:])     otherwise

``build_arpa`` estimates a modified-interpolated model good enough for
tests and toy decoding (production LMs are trained offline and shipped
as .arpa, exactly as the reference ships KenLM binaries).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

LOG10_MIN = -99.0


class ArpaLM:
    """N-gram LM loaded from an ARPA file; log10 scores."""

    def __init__(self, path: str):
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
        self.order = 0
        self._load(path)
        self.vocab = {k[0] for k in self.ngrams[0]} if self.ngrams else set()

    def _load(self, path: str):
        with open(path, "rb") as probe:
            if probe.read(8) == b"OS2SLM01":
                return self._load_binary(path)
        self._load_text(path)

    def _load_binary(self, path: str):
        """Parse the native decoder's mmap binary format
        (`native/ctc_decoder/ngram_lm.cc:SaveBinary`) so the Python
        fallback consumes .blm artifacts too."""
        import struct
        with open(path, "rb") as f:
            data = f.read()
        order, nv = struct.unpack_from("<ii", data, 8)
        (blob_size,) = struct.unpack_from("<q", data, 16)
        blob = data[24:24 + blob_size]
        words = blob.split(b"\0")[:nv]
        id2word = [w.decode("utf-8") for w in words]
        off = 24 + blob_size
        off += (8 - off % 8) % 8
        self.order = order
        self.ngrams = [{} for _ in range(order)]
        for k in range(1, order + 1):
            (count,) = struct.unpack_from("<q", data, off)
            off += 8
            rec = struct.Struct("<{}iff".format(k))
            for _ in range(count):
                fields = rec.unpack_from(data, off)
                off += rec.size
                gram = tuple(id2word[i] for i in fields[:k])
                self.ngrams[k - 1][gram] = (fields[k], fields[k + 1])

    def _load_text(self, path: str):
        section = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1:line.index("-")])
                    while len(self.ngrams) < section:
                        self.ngrams.append({})
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram") or \
                        line == "\\data\\":
                    if line == "\\end\\":
                        break
                    continue
                if section is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    prob = float(parts[0])
                    words = tuple(parts[1:1 + section])
                    backoff = (float(parts[1 + section])
                               if len(parts) > 1 + section else 0.0)
                else:
                    prob = float(parts[0])
                    words = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                if len(words) != section:
                    # malformed gram (e.g. a literal-space token — ARPA
                    # tokens are whitespace-delimited; char LMs must
                    # escape space, see ops/ngram_fusion.py SP): skip
                    # rather than poison the tables
                    continue
                self.ngrams[section - 1][words] = (prob, backoff)

    def log10_cond(self, context: Sequence[str], word: str) -> float:
        """log10 P(word | context) with Katz backoff."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 \
            else ()
        while True:
            entry = self.ngrams[len(context)].get(context + (word,)) \
                if len(context) < self.order else None
            if entry is not None:
                return entry[0]
            if not context:
                uni = self.ngrams[0].get((word,))
                if uni is not None:
                    return uni[0]
                unk = self.ngrams[0].get(("<unk>",))
                return unk[0] if unk else LOG10_MIN
            # back off
            bo_entry = self.ngrams[len(context) - 1].get(context)
            bo = bo_entry[1] if bo_entry else 0.0
            context = context[1:]
            last = self._lookup_suffix(context, word)
            if last is not None:
                return bo + last

    def _lookup_suffix(self, context: Tuple[str, ...], word: str
                       ) -> Optional[float]:
        entry = self.ngrams[len(context)].get(context + (word,))
        if entry is not None:
            return entry[0]
        if not context:
            uni = self.ngrams[0].get((word,))
            if uni is not None:
                return uni[0]
            unk = self.ngrams[0].get(("<unk>",))
            return unk[0] if unk else LOG10_MIN
        bo_entry = self.ngrams[len(context) - 1].get(context)
        bo = bo_entry[1] if bo_entry else 0.0
        result = self._lookup_suffix(context[1:], word)
        return None if result is None else bo + result

    def sentence_log10(self, words: Sequence[str], bos=True, eos=True
                       ) -> float:
        context: List[str] = ["<s>"] if bos else []
        total = 0.0
        seq = list(words) + (["</s>"] if eos else [])
        for w in seq:
            total += self.log10_cond(context, w)
            context.append(w)
        return total


def build_arpa(sentences: Sequence[Sequence[str]], out_path: str,
               order: int = 3, add_k: float = 0.1) -> str:
    """Estimate an add-k interpolated n-gram model and write ARPA."""
    counts = [defaultdict(int) for _ in range(order)]
    vocab = {"<unk>"}
    for sent in sentences:
        toks = ["<s>"] + list(sent) + ["</s>"]
        vocab.update(sent)
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                gram = tuple(toks[i:i + n])
                if n == 1 and gram == ("<s>",):
                    counts[0][gram] += 1  # keep <s> as unigram w/ prob
                    continue
                counts[n - 1][gram] += 1
    vocab.add("</s>")
    vocab.add("<s>")
    V = len(vocab)

    def logp(gram):
        n = len(gram)
        c = counts[n - 1][gram]
        if n == 1:
            total = sum(counts[0].values())
            return math.log10((c + add_k) / (total + add_k * V))
        ctx = counts[n - 2][gram[:-1]] if n >= 2 else 0
        return math.log10((c + add_k) / (ctx + add_k * V))

    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        uni = sorted(vocab)
        grams_per_order = [[(w,) for w in uni]]
        for n in range(2, order + 1):
            grams_per_order.append(sorted(counts[n - 1].keys()))
        for n in range(1, order + 1):
            f.write("ngram {}={}\n".format(n, len(grams_per_order[n - 1])))
        for n in range(1, order + 1):
            f.write("\n\\{}-grams:\n".format(n))
            for gram in grams_per_order[n - 1]:
                p = logp(gram)
                if n < order:
                    # constant backoff weight (simple but valid ARPA)
                    f.write("{:.6f}\t{}\t{:.6f}\n".format(
                        p, " ".join(gram), -0.30103))
                else:
                    f.write("{:.6f}\t{}\n".format(p, " ".join(gram)))
        f.write("\n\\end\\\n")
    return out_path
