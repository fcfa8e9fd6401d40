"""WikiText-103-shaped corpus, with an aclImdb-shaped review tree and an
SST-2-shaped pair of tsv files over the same words, written from a seed:
the LM recipes (``example_configs_torch/lm/``) and the transfer recipes
(``example_configs_torch/transfer/``) read them as they would read the
real directories (WikiText-103, aclImdb and SST-2 are not in the
repository).

    python -m openseq2seq_tpu_torch.test_utils.fake_wikitext --seed 0 DIR

writes

    DIR/wikitext-103/wiki.{train,valid,test}.tokens
    DIR/aclImdb/{train,test}/{pos,neg}/<i>_<stars>.txt
    DIR/SST-2/{train,dev,test}.tsv      ("sentence<TAB>label", a header)

The train split holds each of ``n_types`` word types at least once, and
some ``<unk>`` tokens, so that ``data/lm.Corpus`` builds a vocabulary of
``n_types + 2`` words (``<unk>``, ``<eos>``): at the default 267,734 that
is 267,736, WikiText-103's 267,735 types with ``<unk>``, plus ``<eos>``.
The types are ``.``, ``,`` and lower-case letter strings, shortest first
(the review tokenizer of ``data/lm`` keeps exactly these), drawn with
Zipf-like frequencies (p_k ~ 1 / (k + 1)^1.1) into lines of 8 to 120
tokens. A positive review or sentence draws a third of its words from
one band of a hundred mid-frequency types, a negative one from another,
so that the sentiment can be learnt.

:func:`cycle` writes the toy corpus of ``tests/test_lm.py``: a
deterministic cycle of eight words, whose perplexity a learning LM takes
below 2.
"""
from __future__ import annotations

import argparse
import itertools
import os
import string

import numpy as np

WKT103_TYPES = 267734
_POS_BAND = (100, 200)
_NEG_BAND = (200, 300)
CYCLE = "aa bb cc dd ee ff gg hh "


def word_types(n: int) -> np.ndarray:
    """The first ``n`` types: ``.``, ``,``, then letter strings by length
    and in order."""
    out = [".", ","]
    for k in itertools.count(1):
        for letters in itertools.product(string.ascii_lowercase, repeat=k):
            if len(out) == n:
                return np.array(out, dtype=object)
            out.append("".join(letters))


def _zipf(rng: np.random.RandomState, n_types: int, size: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n_types + 1) ** 1.1
    cdf = np.cumsum(p / p.sum())
    return np.minimum(np.searchsorted(cdf, rng.random_sample(size)),
                      n_types - 1)


def _lines(rng: np.random.RandomState, words: np.ndarray,
           ids: np.ndarray) -> str:
    toks = words[ids]
    cuts = np.cumsum(rng.randint(8, 121, size=len(ids) // 8 + 1))
    cuts = cuts[cuts < len(ids)]
    return "".join(" " + " ".join(line) + " \n"
                   for line in np.split(toks, cuts))


def _split(rng, words, n_tokens, every_type: bool) -> str:
    n_types = len(words)
    ids = _zipf(rng, n_types, n_tokens)
    # WikiText's own <unk> tokens, about one in 200
    ids[rng.random_sample(n_tokens) < 0.005] = n_types
    if every_type:
        ids = np.concatenate([ids, np.arange(n_types)])
    ids = ids[rng.permutation(len(ids))]
    return _lines(rng, np.append(words, "<unk>"), ids)


def _review(rng, words, label: int, length: int) -> str:
    lo, hi = _POS_BAND if label else _NEG_BAND
    ids = _zipf(rng, len(words), length)
    band = rng.random_sample(length) < 1.0 / 3.0
    ids[band] = rng.randint(lo, hi, size=int(band.sum()))
    return " ".join(words[ids])


def generate(root: str, seed: int = 0, n_types: int = WKT103_TYPES,
             n_train_tokens: int = 3_000_000, n_eval_tokens: int = 40_000,
             n_reviews: int = 64, n_sentences: int = 200) -> dict:
    """Write the three corpora under ``root`` and return their
    directories: ``{"wikitext": ..., "imdb": ..., "sst": ...}``."""
    rng = np.random.RandomState(seed)
    words = word_types(n_types)
    wkt = os.path.join(root, "wikitext-103")
    os.makedirs(wkt, exist_ok=True)
    for split, n, every in (("train", n_train_tokens, True),
                            ("valid", n_eval_tokens, False),
                            ("test", n_eval_tokens, False)):
        with open(os.path.join(wkt, "wiki.{}.tokens".format(split)), "w",
                  encoding="utf-8") as f:
            f.write(_split(rng, words, n, every))
    imdb = os.path.join(root, "aclImdb")
    for split in ("train", "test"):
        for label, sub in ((1, "pos"), (0, "neg")):
            d = os.path.join(imdb, split, sub)
            os.makedirs(d, exist_ok=True)
            for i in range(n_reviews):
                stars = rng.randint(7, 11) if label else rng.randint(1, 5)
                with open(os.path.join(d, "{}_{}.txt".format(i, stars)), "w",
                          encoding="utf-8") as f:
                    f.write(_review(rng, words, label,
                                    int(rng.randint(40, 400))))
    sst = os.path.join(root, "SST-2")
    os.makedirs(sst, exist_ok=True)
    for split in ("train", "dev", "test"):
        with open(os.path.join(sst, split + ".tsv"), "w",
                  encoding="utf-8") as f:
            f.write("sentence\tlabel\n")
            for i in range(n_sentences):
                label = int(rng.randint(0, 2))
                f.write("{}\t{}\n".format(
                    _review(rng, words, label, int(rng.randint(4, 40))),
                    label))
    return {"wikitext": wkt, "imdb": imdb, "sst": sst}


def cycle(root: str, train_lines: int = 120, eval_lines: int = 20) -> str:
    """The cycle corpus of ``tests/test_lm.py`` (train.txt, valid.txt,
    test.txt) under ``root``; returns ``root``."""
    os.makedirs(root, exist_ok=True)
    for split in ("train", "valid", "test"):
        n = train_lines if split == "train" else eval_lines
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write((CYCLE + "\n") * n)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_types", type=int, default=WKT103_TYPES)
    ap.add_argument("--n_train_tokens", type=int, default=3_000_000)
    args = ap.parse_args(argv)
    print(generate(args.root, args.seed, args.n_types,
                   args.n_train_tokens))


if __name__ == "__main__":
    main()
