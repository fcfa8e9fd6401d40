r"""Tensor2Tensor-compatible wordpiece subtokenizer.

The port's copy of ``openseq2seq_tpu/data/text2text/wordpiece.py``, unchanged
in behaviour: the same files and seed give the same batches or ids.

The reference's Transformer data pipeline tokenizes with the T2T
``Subtokenizer`` (reference `open_seq2seq/data/text2text/tokenizer.py:61-611`):
a wordpiece vocabulary discovered by iterative count-and-regenerate with the
``min_count`` threshold binary-searched to hit a target vocabulary size, and a
greedy longest-match encoder over escaped tokens. The classic BPE trainer in
`tokenizer.py` cannot reuse a reference-released vocab file token-for-token;
this module can: it implements the same published algorithm (Vaswani et al.'s
tensor2tensor text_encoder), so

* loading a reference-format vocab file (one ``'subtoken'`` per line)
  reproduces the reference tokenizer's integer ids exactly, and
* training on the same corpus with the same ``target_vocab_size`` produces
  the identical vocab file (`tests/test_wordpiece.py` cross-checks both
  against the reference implementation run as an oracle).

Behavioral contract (all verified in tests):
  - reserved ids: ``<pad>``=0, ``<EOS>``=1;
  - text splits into alternating alphanumeric / non-alphanumeric runs;
    single-space runs are dropped unless they open the string;
  - each token is escaped (``\\``->``\\\\``, ``_``->``\\u``, characters
    outside the alphabet or ``\n`` -> ``\<ord>;``) and suffixed with ``_``
    before greedy max-match against the vocabulary;
  - decoding joins adjacent alphanumeric tokens with a single space and
    unescapes;
  - vocabulary candidates are ranked by (count, subtoken) descending with
    single-character alphabet entries appended so any string encodes.
"""
from __future__ import annotations

import collections
import functools
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Set

PAD = "<pad>"
PAD_ID = 0
EOS = "<EOS>"
EOS_ID = 1
RESERVED_TOKENS = [PAD, EOS]

# every escape output must itself be encodable, so these join the alphabet
_ESCAPE_CHARS = set("\\_u;0123456789")
_UNESCAPE_RE = re.compile(r"\\u|\\\\|\\([0-9]+);")
_UNDEFINED_UNICODE = "〓"

# binary-search range for the min-count threshold
_MIN_MIN_COUNT = 1
_MAX_MIN_COUNT = 1000


@functools.lru_cache(maxsize=None)
def _is_alnum(ch: str) -> bool:
    return unicodedata.category(ch)[0] in ("L", "N")


def split_string_to_tokens(text: str) -> List[str]:
    """Alternating alnum / non-alnum runs; interior single spaces drop."""
    if not text:
        return []
    out = []
    start = 0
    flags = [_is_alnum(c) for c in text]
    for pos in range(1, len(text)):
        if flags[pos] != flags[pos - 1]:
            tok = text[start:pos]
            if tok != " " or start == 0:
                out.append(tok)
            start = pos
    out.append(text[start:])
    return out


def join_tokens_to_string(tokens: Sequence[str]) -> str:
    out = []
    prev_alnum = False
    for tok in tokens:
        alnum = bool(tok) and _is_alnum(tok[0])
        if out and prev_alnum and alnum:
            out.append(" ")
        out.append(tok)
        prev_alnum = alnum
    return "".join(out)


def escape_token(token: str, alphabet: Set[str]) -> str:
    token = token.replace("\\", "\\\\").replace("_", "\\u")
    chars = [c if c in alphabet and c != "\n" else "\\%d;" % ord(c)
             for c in token]
    return "".join(chars) + "_"


def unescape_token(token: str) -> str:
    def _sub(m):
        if m.group(1) is None:
            return "_" if m.group(0) == "\\u" else "\\"
        try:
            return chr(int(m.group(1)))
        except (ValueError, OverflowError):
            return _UNDEFINED_UNICODE
    return _UNESCAPE_RE.sub(_sub, token)


def _alphabet_of(iterable: Iterable[str],
                 reserved: Sequence[str]) -> Set[str]:
    alphabet = {c for tok in iterable for c in tok}
    alphabet |= {c for tok in reserved for c in tok}
    alphabet |= _ESCAPE_CHARS
    return alphabet


def _max_match(token: str, vocab: Dict[str, int],
               max_len: int) -> List[str]:
    """Greedy longest-match split of an escaped token."""
    out = []
    start = 0
    n = len(token)
    while start < n:
        for end in range(min(n, start + max_len), start, -1):
            piece = token[start:end]
            if piece in vocab:
                out.append(piece)
                start = end
                break
        else:
            raise ValueError(
                "cannot split token %r — alphabet incomplete" % token)
    return out


class WordpieceSubtokenizer:
    """Encode/decode with a T2T wordpiece vocabulary.

    ``vocab_file`` uses the reference's format: one subtoken per line,
    wrapped in single quotes; reserved tokens are implicit ids 0/1.
    """

    def __init__(self, vocab_file: str,
                 reserved_tokens: Optional[Sequence[str]] = None):
        reserved = list(RESERVED_TOKENS if reserved_tokens is None
                        else reserved_tokens)
        subtokens = []
        with open(vocab_file, encoding="utf-8") as f:
            for line in f:
                tok = line.strip()[1:-1]  # strip surrounding quotes
                if tok in reserved:
                    continue
                subtokens.append(tok)
        self.subtoken_list = reserved + subtokens
        self.alphabet = _alphabet_of(self.subtoken_list, reserved)
        self.subtoken_to_id = {t: i for i, t in
                               enumerate(self.subtoken_list)}
        self.max_subtoken_length = max(
            (len(t) for t in self.subtoken_list), default=0)

    # -- encode / decode ------------------------------------------------

    def encode(self, raw_string: str, add_eos: bool = False) -> List[int]:
        ids = []
        for token in split_string_to_tokens(raw_string):
            pieces = _max_match(escape_token(token, self.alphabet),
                                self.subtoken_to_id,
                                self.max_subtoken_length)
            ids.extend(self.subtoken_to_id[p] for p in pieces)
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, subtoken_ids: Iterable[int]) -> str:
        escaped = "".join(self.subtoken_list[int(s)] for s in subtoken_ids
                          if int(s) < len(self.subtoken_list))
        tokens = [unescape_token(t) for t in escaped.split("_") if t]
        return join_tokens_to_string(tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.subtoken_list)

    # -- vocabulary construction ----------------------------------------

    @classmethod
    def init_from_files(cls, vocab_file: str, files: Sequence[str],
                        target_vocab_size: int, threshold: int,
                        min_count: Optional[int] = None,
                        file_byte_limit: float = 1e6,
                        reserved_tokens: Optional[Sequence[str]] = None
                        ) -> "WordpieceSubtokenizer":
        """Build (or reuse) a wordpiece vocab from corpus files.

        When ``min_count`` is None it is binary-searched so the resulting
        vocabulary lands within ``threshold`` of ``target_vocab_size``
        (reference tokenizer.py:84-120).
        """
        reserved = list(RESERVED_TOKENS if reserved_tokens is None
                        else reserved_tokens)
        if not os.path.exists(vocab_file):
            token_counts = _count_tokens(files, file_byte_limit)
            alphabet = _alphabet_of(token_counts, reserved)
            subtoken_list = _build_to_target_size(
                token_counts, alphabet, target_vocab_size, threshold,
                min_count, reserved)
            with open(vocab_file, "w", encoding="utf-8") as f:
                for tok in subtoken_list:
                    f.write("'%s'\n" % tok)
        return cls(vocab_file, reserved_tokens=reserved)


def _count_tokens(files: Sequence[str],
                  file_byte_limit: float = 1e6) -> Dict[str, int]:
    """Token counts over samples semi-evenly drawn from each file."""
    counts: Dict[str, int] = collections.defaultdict(int)
    for path in files:
        budget = file_byte_limit
        skip_every = int(os.path.getsize(path) / (budget * 2))
        counter = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                if counter < skip_every:
                    counter += 1
                    continue
                if budget < 0:
                    break
                line = line.strip()
                budget -= len(line)
                counter = 0
                for tok in split_string_to_tokens(line):
                    counts[tok] += 1
    return counts


def _count_substrings(token_counts: Dict[str, int], alphabet: Set[str],
                      vocab: Dict[str, int],
                      max_len: int) -> Dict[str, int]:
    """Counts of every substring starting at a current-split boundary."""
    sub_counts: Dict[str, int] = collections.defaultdict(int)
    for token, count in token_counts.items():
        escaped = escape_token(token, alphabet)
        start = 0
        for piece in _max_match(escaped, vocab, max_len):
            for end in range(start + 1, len(escaped) + 1):
                sub_counts[escaped[start:end]] += count
            start += len(piece)
    return sub_counts


def _next_vocab(sub_counts: Dict[str, int], min_count: int,
                alphabet: Set[str], reserved: Sequence[str]):
    """Pick subtokens >= min_count, longest first, discounting the counts
    of each accepted subtoken's prefixes (reference tokenizer.py:499-560)."""
    buckets: List[Set[str]] = []
    for tok, count in sub_counts.items():
        if count < min_count:
            continue
        while len(buckets) <= len(tok):
            buckets.append(set())
        buckets[len(tok)].add(tok)
    max_len = len(buckets) - 1

    candidates = []
    for length in range(max_len, 0, -1):
        for tok in buckets[length]:
            count = sub_counts[tok]
            if count < min_count:  # drained by a longer acceptance
                continue
            if tok not in alphabet and tok not in reserved:
                candidates.append((count, tok))
            for end in range(1, length):
                sub_counts[tok[:end]] -= count
    candidates.extend((sub_counts.get(a, 0), a) for a in alphabet)
    vocab = [t for _, t in sorted(candidates, reverse=True)]
    return list(reserved) + vocab, max_len


def _generate_subtokens(token_counts: Dict[str, int], alphabet: Set[str],
                        min_count: int, num_iterations: int = 4,
                        reserved: Sequence[str] = ()) -> List[str]:
    subtoken_list = list(reserved) + list(alphabet)
    max_len = 1
    for _ in range(num_iterations):
        vocab = {t: i for i, t in enumerate(subtoken_list)}
        sub_counts = _count_substrings(token_counts, alphabet, vocab,
                                       max_len)
        subtoken_list, max_len = _next_vocab(sub_counts, min_count,
                                             alphabet, reserved)
    return subtoken_list


def _build_to_target_size(token_counts, alphabet, target_size, threshold,
                          min_count, reserved) -> List[str]:
    if min_count is not None:
        return _generate_subtokens(token_counts, alphabet, min_count,
                                   reserved=reserved)

    def bisect(lo: int, hi: int) -> List[str]:
        cur = (lo + hi) // 2
        vocab = _generate_subtokens(token_counts, alphabet, cur,
                                    reserved=reserved)
        size = len(vocab)
        if abs(size - target_size) < threshold or lo >= hi or cur < 2:
            return vocab
        other = bisect(cur + 1, hi) if size > target_size \
            else bisect(lo, cur - 1)
        if abs(len(other) - target_size) < abs(size - target_size):
            return other
        return vocab

    return bisect(_MIN_MIN_COUNT, _MAX_MIN_COUNT)
