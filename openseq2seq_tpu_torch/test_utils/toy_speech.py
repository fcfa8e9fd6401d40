"""Synthetic toy speech dataset for convergence tests (the port's copy of
``openseq2seq_tpu/test_utils/toy_speech.py``: the same seed writes the
same wavs).

The reference ships 10 real wavs (`open_seq2seq/test_utils/
toy_speech_data/`) and trains real models on them in its test suite
(`models/speech2text_test.py:20-351`). We synthesize an equivalent
deterministic dataset instead of shipping binaries: each character is a
pure tone with a distinct frequency (space = silence), so a small CTC
model can learn the mapping in a few hundred steps.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from scipy.io import wavfile

SAMPLE_RATE = 16000
CHAR_SECONDS = 0.09
VOCAB = " abcdefgh"
_BASE_FREQ = 220.0

TRANSCRIPTS = [
    "abc bca",
    "dec ade",
    "fg hfa",
    "bad cab",
    "egg fed",
    "ha ha",
    "cafe bead",
    "dad gag",
    "face bag",
    "he had",
]


# ---------------------------------------------------------------------------
# decode-ladder corpus (offline inference-stack evaluation): the third
# word is a DETERMINISTIC function of the first — a long-range
# dependency a bigram LM cannot capture but a neural rescorer can — and
# the third-word vocabulary comes in acoustically-confusable pairs
# (final chars adjacent in tone frequency), so a degraded acoustic
# model makes word errors that (a) an n-gram LM fixes when they form
# non-words and (b) only the rescorer fixes when they form valid-but-
# inconsistent words. Mirrors the reference's published WER ladder
# greedy -> beam+LM -> neural rescore (speech-recognition/jasper.rst).
LADDER_W1 = ["abc", "dec", "egg", "had"]
# second words are mutually acoustically DISTINCT (no equiprobable
# near-homophones): an error no language model could fix — "ha" vs
# "he" are both valid continuations of every first word with equal
# prior — must not dominate the residual error mass
LADDER_W2 = ["ha", "gag", "cab", "fed"]
LADDER_W3 = {"abc": "bca", "dec": "bcb", "egg": "dfe", "had": "dfd"}


def ladder_sentences() -> List[str]:
    return ["{} {} {}".format(w1, w2, LADDER_W3[w1])
            for w1 in LADDER_W1 for w2 in LADDER_W2]


def _char_freq(c: str) -> float:
    idx = VOCAB.index(c)
    return _BASE_FREQ * (1.3 ** idx)


def synth_transcript(text: str, rng: np.random.RandomState,
                     noise: float = 0.01) -> np.ndarray:
    """``noise`` is the additive-Gaussian level relative to unit tones —
    raise it to synthesize acoustically degraded (low-SNR) utterances
    for decode-ladder evaluations."""
    n = int(CHAR_SECONDS * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    # fade in/out to avoid clicks
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (n * 0.1))
    pieces: List[np.ndarray] = [np.zeros(n // 2)]
    for c in text:
        if c == " ":
            pieces.append(np.zeros(n))
        else:
            f = _char_freq(c)
            tone = 0.5 * np.sin(2 * np.pi * f * t) \
                + 0.25 * np.sin(2 * np.pi * 2 * f * t)
            pieces.append(tone * env)
    pieces.append(np.zeros(n // 2))
    signal = np.concatenate(pieces)
    signal = signal + noise * rng.randn(len(signal))
    return (signal / np.max(np.abs(signal)) * 0.8 * 32767).astype(np.int16)


def generate(out_dir: str, transcripts: List[str] = None,
             seed: int = 0, noise: float = 0.01,
             csv_name: str = "toy_data.csv") -> Tuple[str, str]:
    """Write wavs + CSV + vocab into ``out_dir``. Returns
    (csv_path, vocab_path)."""
    transcripts = transcripts or TRANSCRIPTS
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = ["wav_filename,wav_filesize,transcript"]
    for i, text in enumerate(transcripts):
        wav_path = os.path.join(out_dir, "toy_{}.wav".format(i))
        signal = synth_transcript(text, rng, noise=noise)
        wavfile.write(wav_path, SAMPLE_RATE, signal)
        rows.append("{},{},{}".format(wav_path, os.path.getsize(wav_path),
                                      text))
    csv_path = os.path.join(out_dir, csv_name)
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    vocab_path = os.path.join(out_dir, "vocab.txt")
    with open(vocab_path, "w") as f:
        for c in VOCAB:
            f.write(c + "\n")
    return csv_path, vocab_path
