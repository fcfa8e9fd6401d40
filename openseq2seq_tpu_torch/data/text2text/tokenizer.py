"""Subword tokenizer (the port's copy of
``openseq2seq_tpu/data/text2text/tokenizer.py``, unchanged in behaviour:
the same corpus gives the same merges and ids; reference
`open_seq2seq/data/text2text/tokenizer.py:61-611`, the Tensor2Tensor
Subtokenizer, plus the sentencepiece wrapper `tokenizer_wrapper.py`).

Classic byte-pair-encoding trained from a corpus: words are split into
characters with an end-of-word marker, the most frequent adjacent pair
is merged iteratively, and encoding greedily applies the learned merges.
Ids 0-3 are reserved for PAD/EOS/S/UNK matching the text2text data
layer's convention (`text2text.py` SpecialTextTokens).

Vocab file format: one subtoken per line (merge order); reload with
:meth:`Subtokenizer.from_vocab_file`.
"""
from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

EOW = "</w>"
RESERVED = ["<PAD>", "</S>", "<S>", "<UNK>"]
PAD_ID, EOS_ID, S_ID, UNK_ID = 0, 1, 2, 3


def _word_tokens(text: str) -> List[str]:
    return re.findall(r"\S+", text)


class Subtokenizer:

    def __init__(self, merges: List[Tuple[str, str]],
                 vocab: Optional[List[str]] = None):
        self.merges = merges
        self.merge_ranks = {pair: i for i, pair in enumerate(merges)}
        if vocab is None:
            vocab = self._vocab_from_merges()
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    @classmethod
    def init_from_files(cls, corpus_files: Sequence[str],
                        target_vocab_size: int = 8000,
                        min_count: int = 2) -> "Subtokenizer":
        counts: collections.Counter = collections.Counter()
        for path in corpus_files:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    counts.update(_word_tokens(line))
        return cls.train(counts, target_vocab_size, min_count)

    @classmethod
    def train(cls, word_counts: Dict[str, int],
              target_vocab_size: int = 8000,
              min_count: int = 2) -> "Subtokenizer":
        words = {tuple(w) + (EOW,): c for w, c in word_counts.items()
                 if c >= min_count}
        base_chars = sorted({ch for w in words for ch in w})
        merges: List[Tuple[str, str]] = []
        max_merges = max(target_vocab_size - len(base_chars) -
                         len(RESERVED), 0)
        for _ in range(max_merges):
            pairs: collections.Counter = collections.Counter()
            for w, c in words.items():
                for i in range(len(w) - 1):
                    pairs[(w[i], w[i + 1])] += c
            if not pairs:
                break
            best, freq = pairs.most_common(1)[0]
            if freq < min_count:
                break
            merges.append(best)
            merged = best[0] + best[1]
            new_words = {}
            for w, c in words.items():
                out, i = [], 0
                while i < len(w):
                    if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                new_words[tuple(out)] = c
            words = new_words
        vocab = RESERVED + base_chars + [a + b for a, b in merges]
        return cls(merges, vocab)

    def _vocab_from_merges(self) -> List[str]:
        chars = sorted({c for pair in self.merges for c in pair
                        if len(c) == 1})
        return RESERVED + chars + [a + b for a, b in self.merges]

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save_vocab(self, path: str):
        """Two sections: the id-ordered vocab, then the merge list."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("#vocab\n")
            for tok in self.vocab:
                f.write(tok + "\n")
            f.write("#merges\n")
            for a, b in self.merges:
                f.write("{} {}\n".format(a, b))

    @classmethod
    def from_vocab_file(cls, path: str) -> "Subtokenizer":
        vocab: List[str] = []
        merges: List[Tuple[str, str]] = []
        section = "vocab"
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line == "#vocab":
                    section = "vocab"
                    continue
                if line == "#merges":
                    section = "merges"
                    continue
                if section == "vocab":
                    vocab.append(line)
                else:
                    parts = line.split(" ")
                    if len(parts) == 2:
                        merges.append((parts[0], parts[1]))
        return cls(merges, vocab=vocab or None)

    # ------------------------------------------------------------------
    # encode/decode
    # ------------------------------------------------------------------
    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        pieces = list(word) + [EOW]
        while len(pieces) > 1:
            candidates = [(self.merge_ranks.get(
                (pieces[i], pieces[i + 1]), 1 << 30), i)
                for i in range(len(pieces) - 1)]
            rank, i = min(candidates)
            if rank >= 1 << 30:
                break
            pieces = pieces[:i] + [pieces[i] + pieces[i + 1]] + \
                pieces[i + 2:]
        self._cache[word] = pieces
        return pieces

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        for word in _word_tokens(text):
            for piece in self._bpe(word):
                ids.append(self.token_to_id.get(piece, UNK_ID))
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, S_ID, UNK_ID):
                continue
            pieces.append(self.vocab[i] if i < len(self.vocab) else "")
        text = "".join(pieces).replace(EOW, " ")
        return text.strip()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
