"""WMT-shaped synthetic parallel corpus (the port's copy of
``openseq2seq_tpu/test_utils/fake_wmt.py``: the same arguments write the
same files): exercises the NMT recipes end to end — vocab
contract, ParallelText bucketing, KV-cache beam infer, score_bleu —
exactly as a real WMT mount would, plus the wordpiece + t2t-records
leg (`data/text2text/wordpiece.py`, `t2t.py`).

The synthetic language is engineered to be LEARNABLE but not trivial:

  * source sentences are zipf-distributed sequences over ``n_types``
    invented word types (``wNNN``);
  * the "translation" applies a word-level bijective lexicon
    (``wNNN`` -> ``xNNN``), swaps adjacent word pairs, and suffixes
    every target word with ``q`` or ``z`` depending on the PARITY of
    the PRECEDING source word's id (sentence-length parity for the
    first word) — so a correct translation requires attending
    cross-position context, not just memorizing a dictionary.

A converged model reaches ~100 BLEU on a held split; the turnkey bar
is the recorded achievable number, analogous to the Jasper synthetic
corpus's WER 0.0 (`test_utils/fake_librispeech.py`).

Directory layout matches what the recipe's ``WMT16_DIR`` expects
(reference preprocessing output, `get_en_de.sh` naming):

    train.clean.{en,de}.shuffled.BPE_common.32K.tok
    wmt13-en-de.{src,ref}.BPE_common.32K.tok     (dev)
    wmt14-en-de.{src,ref}.BPE_common.32K.tok     (test; infer reads src)
    m_common.vocab                                (shared, specials first)
    t2t/vocab.ende.sub + t2t/train-*.tfrecord + t2t/dev-0.tfrecord
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

SPECIALS = ["<PAD>", "</S>", "<S>", "<UNK>"]


def _translate(words: List[int], n_types: int) -> List[str]:
    """Apply lexicon + context suffix + pair swap (see module doc)."""
    out = []
    for i, w in enumerate(words):
        prev_parity = (len(words) % 2) if i == 0 else (words[i - 1] % 2)
        suffix = "q" if prev_parity == 0 else "z"
        out.append("x%03d%s" % (w, suffix))
    # swap adjacent pairs (odd tail stays)
    for i in range(0, len(out) - 1, 2):
        out[i], out[i + 1] = out[i + 1], out[i]
    return out


def _make_pair(rng: np.random.RandomState, n_types: int
               ) -> Tuple[str, str]:
    n = int(rng.randint(6, 23))
    words = (rng.zipf(1.3, size=n) % n_types).astype(int).tolist()
    src = " ".join("w%03d" % w for w in words)
    tgt = " ".join(_translate(words, n_types))
    return src, tgt


def generate(out_dir: str, n_train: int = 60000, n_dev: int = 1024,
             n_test: int = 1024, n_types: int = 512, seed: int = 0,
             with_t2t: bool = True) -> str:
    """Create the corpus (idempotent via a manifest stamp)."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, ".manifest")
    stamp = "v1:{}:{}:{}:{}:{}:{}".format(n_train, n_dev, n_test,
                                          n_types, seed, with_t2t)
    if os.path.exists(manifest) and open(manifest).read() == stamp:
        return out_dir

    rng = np.random.RandomState(seed)

    def write_split(n, src_path, tgt_path):
        with open(src_path, "w") as fs, open(tgt_path, "w") as ft:
            for _ in range(n):
                s, t = _make_pair(rng, n_types)
                fs.write(s + "\n")
                ft.write(t + "\n")

    j = os.path.join
    write_split(n_train,
                j(out_dir, "train.clean.en.shuffled.BPE_common.32K.tok"),
                j(out_dir, "train.clean.de.shuffled.BPE_common.32K.tok"))
    write_split(n_dev,
                j(out_dir, "wmt13-en-de.src.BPE_common.32K.tok"),
                j(out_dir, "wmt13-en-de.ref.BPE_common.32K.tok"))
    write_split(n_test,
                j(out_dir, "wmt14-en-de.src.BPE_common.32K.tok"),
                j(out_dir, "wmt14-en-de.ref.BPE_common.32K.tok"))

    # shared vocab, specials first (recipe reads m_common.vocab with
    # special_tokens_already_in_vocab default True)
    with open(j(out_dir, "m_common.vocab"), "w") as f:
        for tok in SPECIALS:
            f.write(tok + "\n")
        for w in range(n_types):
            f.write("w%03d\n" % w)
        for w in range(n_types):
            f.write("x%03dq\n" % w)
            f.write("x%03dz\n" % w)

    if with_t2t:
        _build_t2t(out_dir)

    with open(manifest, "w") as f:
        f.write(stamp)
    return out_dir


def _build_t2t(out_dir: str, n_shards: int = 4):
    """Wordpiece vocab (T2T algorithm) + t2t TFRecords over the same
    corpus — the TransformerDataLayer leg."""
    from ..data.text2text.t2t import write_tfrecords
    from ..data.text2text.wordpiece import WordpieceSubtokenizer

    j = os.path.join
    t2t_dir = j(out_dir, "t2t")
    os.makedirs(t2t_dir, exist_ok=True)
    src = j(out_dir, "train.clean.en.shuffled.BPE_common.32K.tok")
    tgt = j(out_dir, "train.clean.de.shuffled.BPE_common.32K.tok")
    sub = WordpieceSubtokenizer.init_from_files(
        j(t2t_dir, "vocab.ende.sub"), [src, tgt],
        target_vocab_size=4096, threshold=1024)

    def pairs(src_path, tgt_path):
        with open(src_path) as fs, open(tgt_path) as ft:
            for s, t in zip(fs, ft):
                yield {"inputs": sub.encode(s.strip(), add_eos=True),
                       "targets": sub.encode(t.strip(), add_eos=True)}

    train = list(pairs(src, tgt))
    per = -(-len(train) // n_shards)
    for i in range(n_shards):
        write_tfrecords(j(t2t_dir, "train-%d.tfrecord" % i),
                        train[i * per:(i + 1) * per])
    write_tfrecords(
        j(t2t_dir, "dev-0.tfrecord"),
        pairs(j(out_dir, "wmt13-en-de.src.BPE_common.32K.tok"),
              j(out_dir, "wmt13-en-de.ref.BPE_common.32K.tok")))
    return sub.vocab_size
