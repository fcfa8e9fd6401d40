"""CTC prefix beam search with an optional n-gram LM and vocabulary trie,
on the host (port of ``openseq2seq_tpu/ops/ctc_beam.py``, numpy only, the
same code).

Functional parity with the reference's two native decoders:
  * the Baidu-style SWIG package — ``ctc_beam_search_decoder[_batch]``,
    stateful streaming ``BeamDecoder`` with word timestamps, pruning via
    ``cutoff_prob`` / ``cutoff_top_n`` (`decoders/
    ctc_beam_search_decoder.{h,cpp}`, `path_trie.{h,cpp}`);
  * the in-graph KenLM TF op's word scoring: completed words get
    ``alpha * log P_lm(word | context) + beta`` (`ctc_decoder_with_lm/
    beam_search.h:68-100`), with a character-trie constraint.

It dispatches to the repository's native C++ library
(``native/ctc_decoder``, through ``ops/ctc_beam_native.py``) when that is
built or can be built — the same algorithm, multithreaded — and
otherwise runs the Python path here (the tests hold the two equal). The
LM is ``ops/arpa_lm.py``'s.

Conventions: ``probs`` are per-frame probability distributions
(T, V) with the CTC blank as the LAST class; the alphabet maps id ->
char with ' ' as the word separator.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arpa_lm import ArpaLM

LOG0 = -1e30
_LN10 = math.log(10.0)


def _logsumexp(a: float, b: float) -> float:
    if a <= LOG0:
        return b
    if b <= LOG0:
        return a
    mx = max(a, b)
    return mx + math.log1p(math.exp(min(a, b) - mx))


class CharTrie:
    """Character trie over a word list (vocabulary constraint, reference
    `ctc_decoder_with_lm/trie_node.h` / `decoders/path_trie`)."""

    __slots__ = ("children", "is_word")

    def __init__(self):
        self.children: Dict[str, "CharTrie"] = {}
        self.is_word = False

    @classmethod
    def from_words(cls, words) -> "CharTrie":
        root = cls()
        for w in words:
            node = root
            for ch in w:
                node = node.children.setdefault(ch, cls())
            node.is_word = True
        return root

    def walk(self, prefix: str) -> Optional["CharTrie"]:
        node = self
        for ch in prefix:
            node = node.children.get(ch)
            if node is None:
                return None
        return node


class Scorer:
    """Word- or character-level LM scorer (reference
    `decoders/scorer.{h,cpp}`): score(token|ctx) = alpha * ln P_lm +
    beta, natural-log domain.

    Character-based LMs (Mandarin-style; reference
    ``Scorer::is_character_based``, `scorer.h:60`) are auto-detected:
    when every LM vocabulary entry is a single character, scoring
    applies per emitted character (no space segmentation, no trie)."""

    def __init__(self, alpha: float, beta: float, model_path: str,
                 vocabulary: Optional[Sequence[str]] = None,
                 trie_vocab: Optional[Sequence[str]] = None,
                 dict_constrained: bool = False):
        """``dict_constrained`` enables the hard lexicon constraint: a
        beam may only close words present in the trie (the reference's
        FSTMATCH mode, `decoders/ctc_beam_search_decoder.cpp:104-120`).
        ``model_path`` may be text ARPA or the mmap binary format
        (``scripts/build_lm.py --binarize``), auto-detected."""
        self.alpha = alpha
        self.beta = beta
        self.model_path = model_path
        self.custom_trie_vocab = trie_vocab
        self.dict_constrained = dict_constrained
        self._native_scorer = None  # lazy NativeScorer cache
        self.lm = ArpaLM(model_path)
        content = self.lm.vocab - {"<s>", "</s>", "<unk>"}
        self.is_character_based = bool(content) and all(
            len(w) == 1 for w in content)
        if self.is_character_based:
            self.trie = None
        else:
            words = trie_vocab if trie_vocab is not None else \
                sorted(content)
            self.trie = CharTrie.from_words(words) if words else None
        del vocabulary  # reference API slot (char list); unused here

    def score_word(self, word: str, context: Sequence[str]) -> float:
        lp10 = self.lm.log10_cond(list(context), word)
        return self.alpha * lp10 * _LN10 + self.beta

    def score_eos(self, context: Sequence[str]) -> float:
        lp10 = self.lm.log10_cond(list(context), "</s>")
        return self.alpha * lp10 * _LN10


class _Prefix:
    __slots__ = ("lp_b", "lp_nb", "times")

    def __init__(self, lp_b=LOG0, lp_nb=LOG0, times=()):
        self.lp_b = lp_b
        self.lp_nb = lp_nb
        self.times = times

    @property
    def total(self):
        return _logsumexp(self.lp_b, self.lp_nb)


def _prune_frame(frame: np.ndarray, cutoff_prob: float, cutoff_top_n: int
                 ) -> List[Tuple[int, float]]:
    order = np.argsort(frame)[::-1]
    picked, cum = [], 0.0
    for idx in order[:cutoff_top_n]:
        p = float(frame[idx])
        if p <= 1e-12 and picked:
            break
        picked.append((int(idx), math.log(max(p, 1e-12))))
        cum += p
        if cum >= cutoff_prob:
            break
    return picked


def ctc_beam_search_decoder(probs: np.ndarray,
                            alphabet: Sequence[str],
                            beam_size: int = 100,
                            cutoff_prob: float = 1.0,
                            cutoff_top_n: int = 40,
                            ext_scorer: Optional[Scorer] = None,
                            blank_id: Optional[int] = None,
                            with_timestamps: bool = False):
    """Decode one utterance. Returns list of (score, text) best-first
    (and (score, text, times) when ``with_timestamps``)."""
    T, V = probs.shape
    if blank_id is None:
        blank_id = V - 1
    space_ids = {i for i, c in enumerate(alphabet) if c == " "}
    trie = ext_scorer.trie if ext_scorer is not None else None

    beams: Dict[Tuple[int, ...], _Prefix] = {
        (): _Prefix(lp_b=0.0, lp_nb=LOG0)}
    word_ctx: Dict[Tuple[int, ...], Tuple[str, ...]] = {(): ()}

    for t in range(T):
        frame = probs[t]
        pruned = _prune_frame(frame, cutoff_prob, cutoff_top_n)
        new_beams: Dict[Tuple[int, ...], _Prefix] = {}
        new_ctx: Dict[Tuple[int, ...], Tuple[str, ...]] = {}

        def get(prefix):
            if prefix not in new_beams:
                new_beams[prefix] = _Prefix()
            return new_beams[prefix]

        for prefix, pb in beams.items():
            ctx = word_ctx[prefix]
            for cid, lp_c in pruned:
                if cid == blank_id:
                    entry = get(prefix)
                    entry.lp_b = _logsumexp(entry.lp_b, pb.total + lp_c)
                    entry.times = entry.times or pb.times
                    new_ctx.setdefault(prefix, ctx)
                    continue
                last = prefix[-1] if prefix else None
                if cid == last:
                    # repeat merges into the same prefix...
                    entry = get(prefix)
                    entry.lp_nb = _logsumexp(entry.lp_nb,
                                             pb.lp_nb + lp_c)
                    entry.times = entry.times or pb.times
                    new_ctx.setdefault(prefix, ctx)
                    # ...and a blank-separated repeat extends it
                    if pb.lp_b > LOG0:
                        ext = prefix + (cid,)
                        add = pb.lp_b + lp_c
                        add, ectx = _maybe_score_word(
                            add, ext, ctx, cid, space_ids, alphabet,
                            ext_scorer, trie)
                        # create the beam entry only for admitted
                        # extensions — a scorer/trie-rejected (-inf)
                        # one would otherwise survive wide-beam
                        # pruning as a ctx-less empty prefix
                        if add > LOG0:
                            e2 = get(ext)
                            e2.lp_nb = _logsumexp(e2.lp_nb, add)
                            e2.times = e2.times or (pb.times + (t,))
                            new_ctx.setdefault(ext, ectx)
                    continue
                ext = prefix + (cid,)
                add = pb.total + lp_c
                add, ectx = _maybe_score_word(
                    add, ext, ctx, cid, space_ids, alphabet, ext_scorer,
                    trie)
                if add > LOG0:
                    entry = get(ext)
                    entry.lp_nb = _logsumexp(entry.lp_nb, add)
                    entry.times = entry.times or (pb.times + (t,))
                    new_ctx.setdefault(ext, ectx)

        ranked = sorted(new_beams.items(), key=lambda kv: -kv[1].total)
        beams = dict(ranked[:beam_size])
        word_ctx = {k: new_ctx[k] for k in beams}

    results = []
    for prefix, pb in beams.items():
        score = pb.total
        if ext_scorer is not None and \
                not getattr(ext_scorer, "is_character_based", False):
            # score the trailing partial word + sentence end
            ctx = list(word_ctx[prefix])
            text = "".join(alphabet[i] for i in prefix)
            tail = text.rsplit(" ", 1)[-1] if text else ""
            if tail:
                score += ext_scorer.score_word(tail, ctx)
                ctx.append(tail)
        text = "".join(alphabet[i] for i in prefix)
        if with_timestamps:
            results.append((score, text, list(pb.times)))
        else:
            results.append((score, text))
    results.sort(key=lambda r: -r[0])
    return results


def _maybe_score_word(logp, ext_prefix, ctx, cid, space_ids, alphabet,
                      scorer, trie):
    """Apply LM word score when a space closes a word; apply the trie
    constraint on the in-progress word. Character-based LMs score every
    emitted character instead (reference `scorer.h:60`)."""
    if scorer is None:
        return logp, ctx
    if getattr(scorer, "is_character_based", False):
        ch = alphabet[cid]
        logp += scorer.score_word(ch, list(ctx))
        new = ctx + (ch,)
        max_ctx = max(scorer.lm.order - 1, 0)
        return logp, new[-max_ctx:] if max_ctx else ()
    if cid in space_ids:
        # word completed: everything since the previous space
        chars = [alphabet[i] for i in ext_prefix[:-1]]
        text = "".join(chars)
        word = text.rsplit(" ", 1)[-1]
        if word:
            # hard lexicon constraint (reference FSTMATCH): the word
            # must be complete in the trie, not just a valid prefix
            if getattr(scorer, "dict_constrained", False) and \
                    trie is not None:
                node = trie.walk(word)
                if node is None or not node.is_word:
                    return LOG0, ctx
            logp += scorer.score_word(word, list(ctx))
            return logp, ctx + (word,)
        return logp, ctx
    if trie is not None:
        chars = [alphabet[i] for i in ext_prefix]
        partial = "".join(chars).rsplit(" ", 1)[-1]
        if trie.walk(partial) is None:
            return LOG0, ctx
    return logp, ctx


def _native_scorer_for(ext_scorer):
    """Build (and cache on the Scorer) the C++ twin of a Python Scorer,
    when the native library is available and the scorer has no custom
    trie vocabulary (the native trie always mirrors the LM vocab)."""
    native = _get_native()
    if native is None or ext_scorer is None:
        return None
    if ext_scorer.custom_trie_vocab is not None:
        return None
    if ext_scorer._native_scorer is None:
        try:
            ext_scorer._native_scorer = native.NativeScorer(
                ext_scorer.alpha, ext_scorer.beta, ext_scorer.model_path,
                dict_constrained=ext_scorer.dict_constrained)
        except (RuntimeError, ValueError):
            return None
    return ext_scorer._native_scorer


def ctc_beam_search_decoder_batch(probs_list, seq_lens, alphabet,
                                  beam_size=100, num_processes=1,
                                  cutoff_prob=1.0, cutoff_top_n=40,
                                  ext_scorer=None, blank_id=None):
    """Batch decode (the native backend threads this; the Python path
    is sequential). Dispatches to C++ both with and without an LM
    scorer (the scorer's native twin is built from the same ARPA)."""
    native = _get_native()
    if native is not None:
        native_scorer = _native_scorer_for(ext_scorer) \
            if ext_scorer is not None else None
        if ext_scorer is None or native_scorer is not None:
            return native.decode_batch(
                probs_list, seq_lens, alphabet, beam_size, cutoff_prob,
                cutoff_top_n, -1 if blank_id is None else blank_id,
                scorer=native_scorer, num_threads=num_processes)
    out = []
    for probs, n in zip(probs_list, seq_lens):
        out.append(ctc_beam_search_decoder(
            np.asarray(probs)[:int(n)], alphabet, beam_size,
            cutoff_prob, cutoff_top_n, ext_scorer, blank_id))
    return out


def ctc_beam_search_decoder_nbest(probs, alphabet, nbest, beam_size=100,
                                  cutoff_prob=1.0, cutoff_top_n=40,
                                  ext_scorer=None, blank_id=None):
    """Top-``nbest`` hypotheses for one utterance: [(score, text), ...]
    best-first — the n-best list feeds the neural rescorer
    (`apps/lm_rescorer.py`; reference dumps beams for its external
    TXL rescorer the same way)."""
    native_scorer = _native_scorer_for(ext_scorer)
    native = _get_native()
    if native is not None and (ext_scorer is None or
                               native_scorer is not None):
        return native.decode_nbest(
            np.asarray(probs), alphabet, nbest, beam_size, cutoff_prob,
            cutoff_top_n, -1 if blank_id is None else blank_id,
            scorer=native_scorer)
    res = ctc_beam_search_decoder(np.asarray(probs), alphabet, beam_size,
                                  cutoff_prob, cutoff_top_n, ext_scorer,
                                  blank_id)
    return [(s, t) for s, t in res[:nbest]]


def ctc_greedy_decoder(probs: np.ndarray, alphabet: Sequence[str],
                       blank_id: Optional[int] = None) -> str:
    """Host-side greedy decode (reference `decoders/
    ctc_greedy_decoder.{h,cpp}`)."""
    V = probs.shape[1]
    if blank_id is None:
        blank_id = V - 1
    best = np.argmax(probs, axis=1)
    out, prev = [], -1
    for b in best:
        if b != blank_id and b != prev:
            out.append(alphabet[int(b)])
        prev = int(b)
    return "".join(out)


def group_word_timestamps(text: str, times: Sequence[int]
                          ) -> List[Tuple[str, int, int]]:
    """[(word, start_frame, end_frame)] from per-character emission
    frames (shared by the Python and native streaming decoders)."""
    words, start, cur, prev_t = [], None, [], -1
    for ch, t in zip(text, times):
        if ch == " ":
            if cur:
                words.append(("".join(cur), start, prev_t))
            cur, start = [], None
        else:
            if start is None:
                start = t
            cur.append(ch)
            prev_t = t
    if cur:
        words.append(("".join(cur), start, prev_t))
    return words


class BeamDecoder:
    """Stateful streaming decoder with word timestamps (reference
    `decoders/ctc_beam_search_decoder.h` BeamDecoder): feed probability
    chunks with :meth:`decode`, read the best transcript so far, call
    :meth:`reset` between utterances."""

    def __init__(self, alphabet: Sequence[str], beam_size: int = 100,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40,
                 ext_scorer: Optional[Scorer] = None,
                 blank_id: Optional[int] = None):
        self.alphabet = list(alphabet)
        self.beam_size = beam_size
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self.scorer = ext_scorer
        self.blank_id = blank_id
        # the C++ StreamingDecoder keeps beam state across chunks
        # (O(chunk) per call); the Python fallback re-decodes the
        # accumulated history (O(total) per call). Dispatch to native
        # when the library is built, rebuilding the scorer there.
        self._native = None
        native = _get_native()
        if native is not None and (
                ext_scorer is None or
                getattr(ext_scorer, "custom_trie_vocab", None) is None):
            # a custom trie vocabulary only exists Python-side; keep
            # the Python path so the constraint isn't silently dropped
            try:
                nat_scorer = None
                if ext_scorer is not None:
                    nat_scorer = native.NativeScorer(
                        alpha=ext_scorer.alpha, beta=ext_scorer.beta,
                        arpa_path=ext_scorer.model_path)
                self._native = native.NativeStreamingDecoder(
                    alphabet, beam_size, cutoff_prob, cutoff_top_n,
                    -1 if blank_id is None else blank_id, nat_scorer)
            except Exception:
                self._native = None
        self.reset()

    def reset(self):
        self._frames: List[np.ndarray] = []
        self._frame_offset = 0
        if self._native is not None:
            self._native.reset()

    def decode(self, probs_chunk: np.ndarray) -> str:
        """Feed a (T, V) chunk; returns the current best transcript."""
        if self._native is not None:
            return self._native.decode(
                np.asarray(probs_chunk, np.float32))
        self._frames.append(np.asarray(probs_chunk))
        probs = np.concatenate(self._frames, axis=0)
        self._best = ctc_beam_search_decoder(
            probs, self.alphabet, self.beam_size, self.cutoff_prob,
            self.cutoff_top_n, self.scorer, self.blank_id,
            with_timestamps=True)
        return self._best[0][1]

    def get_word_timestamps(self) -> List[Tuple[str, int, int]]:
        """[(word, start_frame, end_frame)] of the current best beam."""
        if self._native is not None:
            return self._native.get_word_timestamps()
        if not getattr(self, "_best", None):
            return []
        _, text, times = self._best[0]
        return group_word_timestamps(text, times)


# ---------------------------------------------------------------------------
# native backend dispatch
# ---------------------------------------------------------------------------
_NATIVE = None
_NATIVE_TRIED = False


def _get_native():
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from . import ctc_beam_native
            _NATIVE = ctc_beam_native if ctc_beam_native.available() \
                else None
        except Exception:
            _NATIVE = None
    return _NATIVE
