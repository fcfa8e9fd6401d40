#!/usr/bin/env python
"""Offline CTC beam-search decoding with n-gram LM rescoring and
alpha/beta grid search over dumped logits, with the PyTorch port's
modules (twin of ``scripts/decode.py``; reference `scripts/decode.py`).

Inputs: a logits pickle written by ``python -m openseq2seq_tpu_torch.run
--mode=infer`` with ``decoder_params/infer_logits_to_pickle True`` ({wav:
(T, V) logits}), the eval CSV with reference transcripts, the char vocab,
and an ARPA LM (``scripts_torch/build_lm.py``). Decoding runs on the
host, through the native decoder (``native/ctc_decoder``, built with its
Makefile when absent) or else the Python one (``ops/ctc_beam.py``).

  python scripts_torch/decode.py --logits=dump.pkl --labels=dev.csv \
      --vocab=vocab.txt --lm=lm.arpa \
      --alpha=1.0 --alpha_max=3.0 --alpha_step=0.5 \
      --beta=0.0 --beta_max=2.0 --beta_step=1.0 --beam_width=128
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from openseq2seq_tpu_torch.data.speech2text.speech2text import \
    load_pre_existing_vocabulary  # noqa: E402
from openseq2seq_tpu_torch.ops.ctc_beam import (Scorer,  # noqa: E402
                                          ctc_beam_search_decoder_batch)
from openseq2seq_tpu_torch.utils.metrics import levenshtein  # noqa: E402


def softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _decode_all(logits_map, wavs, alphabet, lm_path, alpha, beta,
                beam_width):
    """Batch-decode through the native C++ decoder (threaded across
    utterances; the reference's decode.py drives its SWIG decoder the
    same way) — the pure-Python single-utterance oracle is ~100x
    slower at beam 2048."""
    scorer = None
    if lm_path:
        scorer = Scorer(alpha=alpha, beta=beta, model_path=lm_path)
    probs_list = [softmax(np.asarray(logits_map[w], np.float32))
                  for w in wavs]
    lens = [p.shape[0] for p in probs_list]
    res = ctc_beam_search_decoder_batch(
        probs_list, lens, alphabet, beam_size=beam_width,
        num_processes=max(os.cpu_count() or 1, 1), ext_scorer=scorer)
    return {w: r[0][1] for w, r in zip(wavs, res)}


def wer_for_params(logits_map, labels, alphabet, lm_path, alpha, beta,
                   beam_width):
    wavs = [w for w in labels if w in logits_map]
    hyps = _decode_all(logits_map, wavs, alphabet, lm_path, alpha, beta,
                       beam_width)
    total_dist, total_words = 0, 0
    for wav in wavs:
        ref = labels[wav]
        total_dist += levenshtein(ref.split(), hyps[wav].split())
        total_words += len(ref.split())
    return total_dist / max(total_words, 1)


def frange(lo, hi, step):
    vals = []
    v = lo
    while v <= hi + 1e-9:
        vals.append(round(v, 6))
        v += step
    return vals or [lo]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--logits", required=True)
    parser.add_argument("--labels", required=True,
                        help="CSV with wav_filename,...,transcript")
    parser.add_argument("--vocab", required=True)
    parser.add_argument("--lm", default=None, help="ARPA LM path")
    parser.add_argument("--alpha", type=float, default=2.0)
    parser.add_argument("--alpha_max", type=float, default=None)
    parser.add_argument("--alpha_step", type=float, default=0.5)
    parser.add_argument("--beta", type=float, default=0.0)
    parser.add_argument("--beta_max", type=float, default=None)
    parser.add_argument("--beta_step", type=float, default=0.5)
    parser.add_argument("--beam_width", type=int, default=128)
    parser.add_argument("--infer_output_file", default=None)
    args = parser.parse_args(argv)

    with open(args.logits, "rb") as f:
        logits_map = pickle.load(f)
    char2idx = load_pre_existing_vocabulary(args.vocab, read_chars=True)
    alphabet = [c for c, _ in sorted(char2idx.items(),
                                     key=lambda kv: kv[1])]
    labels = {}
    with open(args.labels, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            labels[row["wav_filename"]] = row["transcript"]

    alphas = frange(args.alpha, args.alpha_max or args.alpha,
                    args.alpha_step)
    betas = frange(args.beta, args.beta_max or args.beta, args.beta_step)
    best = (None, None, float("inf"))
    for a in alphas:
        for b in betas:
            wer = wer_for_params(logits_map, labels, alphabet, args.lm,
                                 a, b, args.beam_width)
            print("alpha={:.2f} beta={:.2f} WER={:.4f}".format(a, b, wer),
                  flush=True)
            if wer < best[2]:
                best = (a, b, wer)
    print("BEST: alpha={} beta={} WER={:.4f}".format(*best))

    if args.infer_output_file:
        wavs = list(logits_map)
        hyps = _decode_all(logits_map, wavs, alphabet, args.lm,
                           best[0], best[1], args.beam_width)
        with open(args.infer_output_file, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["wav_filename", "predicted_transcript"])
            for wav in wavs:
                writer.writerow([wav, hyps[wav]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
