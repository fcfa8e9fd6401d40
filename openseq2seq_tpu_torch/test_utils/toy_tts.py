"""Synthetic LJ-style TTS dataset for smoke tests and toy configs:
pure-tone wavs whose frequency encodes the character, with the pipe-CSV
metadata layout of LJSpeech (the dataset the reference's Tacotron
configs target, `example_configs/text2speech/tacotron_LJ.py`)."""
import os

import numpy as np


def generate(out_dir: str, sample_freq: int = 22050):
    from scipy.io import wavfile

    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    texts = ["aba", "bab", "abab", "bb aa", "ab ba", "aabb",
             "ba ab", "abba", "baab", "aa bb"]
    freqs = {"a": 220.0, "b": 440.0, " ": 0.0}
    rows = []
    for i, text in enumerate(texts):
        sig = np.concatenate([
            np.sin(2 * np.pi * freqs[c] *
                   np.arange(int(0.12 * sample_freq)) / sample_freq) *
            (freqs[c] > 0)
            for c in text])
        name = "toy_{:03d}".format(i)
        wavfile.write(os.path.join(wav_dir, name + ".wav"), sample_freq,
                      (sig * 0.8 * 32767).astype(np.int16))
        rows.append("{}|{}|{}".format(name, text, text))
    csv = os.path.join(out_dir, "metadata.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("a\nb\n \n")
    return csv
