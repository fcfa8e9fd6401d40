"""LibriSpeech-shaped synthetic corpus for end-to-end runs of the
host pipeline (the port's copy of
``openseq2seq_tpu/test_utils/fake_librispeech.py``: the same arguments
write the same corpus).

Generates the directory layout the flagship recipe
(`example_configs/speech2text/jasper10x5_LibriSpeech.py`) expects from a
real LibriSpeech import (reference `scripts/import_librivox.py` output:
CSVs with wav_filename,wav_filesize,transcript + a 28-char vocab):

    <dir>/vocab.txt
    <dir>/librivox-train-clean-100.csv   (+ -360 / -other-500 aliases)
    <dir>/librivox-dev-clean.csv
    <dir>/wavs/utt_%05d.wav

Every utterance is exactly ``duration`` seconds (one padded shape) of
band-limited noise; transcripts are fixed-length word
strings over the LibriSpeech a-z+space+apostrophe alphabet so label
shapes are static too. Featurization cost (STFT/mel work) depends only
on length, so throughput numbers transfer to real speech.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

SAMPLE_RATE = 16000
VOCAB = "abcdefghijklmnopqrstuvwxyz '"

_WORDS = ("the quick brown fox jumps over lazy dog and then some more "
          "words that speakers say during ten seconds of audio like "
          "history science people because through country world it's").split()


def _transcript(rng: np.random.RandomState, n_chars: int) -> str:
    words = []
    total = 0
    while total + 1 < n_chars:
        w = _WORDS[rng.randint(len(_WORDS))]
        words.append(w)
        total += len(w) + 1
    text = " ".join(words)[:n_chars]
    return text.strip().ljust(n_chars, "a")   # exact fixed length


def generate(out_dir: str, n_utts: int = 1280, duration: float = 10.0,
             transcript_chars: int = 140, seed: int = 0) -> Tuple[str, str]:
    """Create the corpus (idempotent: returns immediately when the
    manifest already matches). Returns (dir, train_csv_path)."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, ".manifest")
    stamp = "v1:{}:{}:{}:{}".format(n_utts, duration, transcript_chars, seed)
    train_csv = os.path.join(out_dir, "librivox-train-clean-100.csv")
    if os.path.exists(manifest) and open(manifest).read() == stamp:
        return out_dir, train_csv

    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    from scipy.io import wavfile

    n_samples = int(duration * SAMPLE_RATE)
    rows = []
    for i in range(n_utts):
        path = os.path.join(wav_dir, "utt_{:05d}.wav".format(i))
        # band-limited noise: cheap to synthesize, spectrally non-trivial
        sig = rng.randn(n_samples).astype(np.float32)
        sig = np.convolve(sig, np.ones(8) / 8.0, mode="same")
        sig = (sig / (np.abs(sig).max() + 1e-6) * 0.5 * 32767).astype(np.int16)
        wavfile.write(path, SAMPLE_RATE, sig)
        rows.append("{},{},{}".format(
            path, os.path.getsize(path), _transcript(rng, transcript_chars)))

    header = "wav_filename,wav_filesize,transcript"
    with open(train_csv, "w") as f:
        f.write(header + "\n" + "\n".join(rows) + "\n")
    # the flagship recipe concatenates three train CSVs and reads a dev
    # CSV for eval — alias them all to the same file list
    for name in ("librivox-train-clean-360.csv",
                 "librivox-train-other-500.csv"):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(header + "\n")   # empty shards: train list = 1280 utts
    with open(os.path.join(out_dir, "librivox-dev-clean.csv"), "w") as f:
        f.write(header + "\n" + "\n".join(rows[:64]) + "\n")
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(list(VOCAB)) + "\n")
    with open(manifest, "w") as f:
        f.write(stamp)
    return out_dir, train_csv
