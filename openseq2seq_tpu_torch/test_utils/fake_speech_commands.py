"""Labelled one-second tone clips in the Google Speech Commands layout
that ``SpeechCommandsDataLayer`` reads: wavs under ``dataset_location``
and ``train.csv`` / ``test.csv`` of ``<wav>,<label>`` rows. Label k is a
tone at ``toy_speech``'s frequency of its k-th symbol (a tone and its
octave, placed at a random offset in the second), written with the same
synthesis and wav writer as the toy speech set; the noise makes clips of
one label differ.

    python -m openseq2seq_tpu_torch.test_utils.fake_speech_commands <dir>
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile

from .toy_speech import SAMPLE_RATE, VOCAB, synth_transcript


def clip(label: int, rng: np.random.RandomState) -> np.ndarray:
    """One second of int16 audio for ``label`` (< 8): its tone repeated
    four times, then zero-padded at a random offset."""
    tone = synth_transcript(VOCAB[1 + label] * 4, rng, noise=0.02)
    out = np.zeros(SAMPLE_RATE, np.int16)
    start = rng.randint(0, SAMPLE_RATE - len(tone) + 1)
    out[start:start + len(tone)] = tone
    return out


def generate(out_dir: str, num_labels: int = 8, n_train: int = 64,
             n_test: int = 32, seed: int = 0) -> str:
    """Write the wavs and the two csv files under ``out_dir``; returns
    it."""
    if not 2 <= num_labels <= len(VOCAB) - 1:
        raise ValueError("num_labels must be 2 to {}".format(len(VOCAB) - 1))
    os.makedirs(os.path.join(out_dir, "clips"), exist_ok=True)
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        rows = []
        for i in range(n):
            label = i % num_labels
            rel = os.path.join("clips", "{}_{}.wav".format(split, i))
            wavfile.write(os.path.join(out_dir, rel), SAMPLE_RATE,
                          clip(label, rng))
            rows.append("{},{}".format(rel, label))
        with open(os.path.join(out_dir, split + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--labels", type=int, default=8)
    a = parser.parse_args()
    generate(a.out_dir, a.labels)
