"""LJSpeech-shaped synthetic corpus, written from a seed, for end-to-end
runs of the speech-synthesis recipes (Centaur's and WaveNet's) without
the real corpus:

    <dir>/metadata.csv             id|text|normalized text, every clip
    <dir>/train.csv, test.csv      the same rows, split (the last tenth)
    <dir>/vocab_tts.txt            one character a line
    <dir>/wavs/LJ001-%04d.wav      16-bit mono at ``sample_freq``

Each clip lasts between ``min_seconds`` and ``max_seconds`` (1 to 3 s by
default, so that a clip is longer than WaveNet's 16,384-sample training
chunk at 22,050 Hz) and voices its text one character after another: a
tone whose pitch encodes the character, with its second harmonic and a
little noise. :func:`tones` writes the four 0.5 s tones of the JAX
package's WaveNet test (``tests/test_wavenet.py``), the WaveNet toy's
corpus.

    python -m openseq2seq_tpu_torch.test_utils.fake_ljspeech [--seed 0] \\
        [--clips 64] <dir>
"""
from __future__ import annotations

import argparse
import os

import numpy as np

VOCAB = "abcdefghijklmnopqrstuvwxyz ,.'"
_WORDS = ("printing in the only sense with which we are at present "
          "concerned differs from most if not from all the arts and crafts "
          "represented in exhibition").split()


def _text(rng: np.random.RandomState, n_chars: int) -> str:
    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(_WORDS[rng.randint(len(_WORDS))])
    return " ".join(words)[:n_chars].strip() + "."


def _voice(text: str, n: int, sample_freq: int,
           rng: np.random.RandomState) -> np.ndarray:
    """``n`` samples voicing ``text`` a character at a time."""
    bounds = np.linspace(0, n, len(text) + 1).astype(int)
    t = np.arange(n) / sample_freq
    sig = np.zeros(n)
    for c, lo, hi in zip(text, bounds[:-1], bounds[1:]):
        if c == " ":
            continue
        f = 110.0 + 15.0 * VOCAB.index(c)
        sig[lo:hi] = (np.sin(2 * np.pi * f * t[lo:hi]) +
                      0.3 * np.sin(4 * np.pi * f * t[lo:hi]))
    sig += 0.02 * rng.randn(n)
    return 0.5 * sig / max(np.abs(sig).max(), 1e-6)


def generate(out_dir: str, n_clips: int = 64, seed: int = 0,
             sample_freq: int = 22050, min_seconds: float = 1.0,
             max_seconds: float = 3.0) -> str:
    """Writes the corpus into ``out_dir``; returns ``out_dir``. The same
    arguments write the same files."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rows = []
    for i in range(n_clips):
        seconds = rng.uniform(min_seconds, max_seconds)
        text = _text(rng, max(int(seconds * 14), 4))
        name = "LJ001-{:04d}".format(i + 1)
        sig = _voice(text, int(seconds * sample_freq), sample_freq, rng)
        wavfile.write(os.path.join(wav_dir, name + ".wav"), sample_freq,
                      (sig * 32767).astype(np.int16))
        rows.append("{}|{}|{}".format(name, text, text))
    n_test = max(n_clips // 10, 1)
    for name, part in (("metadata.csv", rows),
                       ("train.csv", rows[:-n_test]),
                       ("test.csv", rows[-n_test:])):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(part) + "\n")
    with open(os.path.join(out_dir, "vocab_tts.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    return out_dir


def tones(out_dir: str, sample_freq: int = 16000) -> str:
    """The JAX package's WaveNet test corpus: four 0.5 s tones of 200 to
    500 Hz (``wavs/w{i}.wav``), ``meta.csv`` and ``vocab.txt``; returns
    ``out_dir``."""
    from scipy.io import wavfile
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rows = []
    for i in range(4):
        t = np.arange(sample_freq // 2) / sample_freq
        sig = np.sin(2 * np.pi * (200 + 100 * i) * t)
        wavfile.write(os.path.join(wav_dir, "w{}.wav".format(i)),
                      sample_freq, (sig * 0.8 * 32767).astype(np.int16))
        rows.append("w{}|text{}|text{}".format(i, i, i))
    with open(os.path.join(out_dir, "meta.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("t\ne\nx\n0\n1\n2\n3\n")
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--clips", type=int, default=64)
    args = parser.parse_args(argv)
    print(generate(args.out_dir, args.clips, args.seed))


if __name__ == "__main__":
    main()
