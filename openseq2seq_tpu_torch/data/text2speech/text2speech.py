"""Text-to-speech data layer (port of
``openseq2seq_tpu/data/text2speech/text2speech.py``, the same batches):
LJSpeech or MAILABS pipe-separated CSVs (``wav_id|raw_text|normalized``),
a character vocabulary, wav -> log mel or log magnitude spectrograms
(``output_type`` mel, magnitude or both), optional feature normalization,
an EOS frame of padding and per-frame stop targets.

Batch contract:
  source_tensors: [text_ids (B, S), text_len (B,)], S padded to 8, each
    text ending in the EOS id ``len(vocab)`` (``src_vocab_size`` is
    ``len(vocab) + 1``);
  target_tensors: [spec (B, T, F), stop_target (B, T), spec_len (B,)],
    T padded to ``pad_to``; stop 0 means "keep going" and 1 "stop", 1 on
    the padding; with ``pad_EOS`` one padding frame counts in spec_len;
  "spec_mag" (B, T, F_mag) as well when ``output_type`` is "both".

Outside training the rows are split among ``num_workers`` in contiguous
shards. In interactive inference ``create_interactive_batch`` makes the
infer batch of one line of text.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List

import numpy as np

from ..data_layer import DataLayer
from ..speech2text.speech2text import load_pre_existing_vocabulary
from .speech_utils import get_speech_features_tts


class Text2SpeechDataLayer(DataLayer):

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "dataset_location": str,
            "dataset": ["LJ", "MAILABS"],
            "num_audio_features": None,
            "output_type": ["magnitude", "mel", "both"],
            "vocab_file": str,
            "dataset_files": list,
            "feature_normalize": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "pad_to": int,
            "mag_power": int,
            "pad_EOS": bool,
            "pad_value": float,
            "feature_normalize_mean": float,
            "feature_normalize_std": float,
            "trim": bool,
            "data_min": None,
            "duration_min": int,
            "duration_max": int,
            "mel_type": ["slaney", "htk"],
            "exp_mag": bool,
            "style_input": [None, "wav"],
            "n_samples_train": int,
            "n_samples_eval": int,
            "n_fft": int,
            "fmax": float,
            "max_normalization": bool,
            "use_cache": bool,
            "sample_freq": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 8)
        p.setdefault("pad_to", 8)
        p.setdefault("mag_power", 1)
        p.setdefault("pad_EOS", True)
        p.setdefault("pad_value", 0.0)
        p.setdefault("n_fft", 1024)
        p.setdefault("sample_freq", 22050)
        p.setdefault("trim", False)
        p.setdefault("data_min", 1e-5)
        p.setdefault("feature_normalize_mean", 0.0)
        p.setdefault("feature_normalize_std", 1.0)

        self.char2idx = load_pre_existing_vocabulary(
            p["vocab_file"], read_chars=True)
        self.idx2char = {i: c for c, i in self.char2idx.items()}
        # +1 for the EOS id appended to each text
        p["src_vocab_size"] = len(self.char2idx) + 1
        self.eos_char_id = len(self.char2idx)

        if p["output_type"] == "both":
            self.n_feats = {"mel": p["num_audio_features"]["mel"],
                            "magnitude":
                                p["num_audio_features"]["magnitude"]}
        elif p["output_type"] == "mel":
            self.n_feats = {"mel": p["num_audio_features"]}
        else:
            self.n_feats = {"magnitude": p["num_audio_features"]}
        p["num_output_features"] = (
            self.n_feats.get("mel") or self.n_feats["magnitude"])

        if p.get("interactive", False):
            self._rows = []
            return
        rows: List = []
        for csv in p["dataset_files"]:
            with open(csv, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("|")
                    if len(parts) >= 2:
                        rows.append(parts)
        n_cap = p.get("n_samples_train" if p["mode"] == "train"
                      else "n_samples_eval", None)
        if n_cap:
            rows = rows[:n_cap]
        if p["mode"] != "train" and num_workers > 1:
            n = len(rows)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            rows = rows[start:end]
        self._rows = rows

    def get_size_in_samples(self) -> int:
        return len(self._rows)

    def _wav_path(self, wav_id: str) -> str:
        loc = self._params["dataset_location"]
        if wav_id.endswith(".wav"):
            return os.path.join(loc, wav_id)
        return os.path.join(loc, "wavs", wav_id + ".wav")

    def encode_text(self, text: str) -> np.ndarray:
        """The ids of the characters in the vocabulary, then EOS."""
        ids = [self.char2idx[c] for c in text if c in self.char2idx]
        ids.append(self.eos_char_id)
        return np.asarray(ids, np.int32)

    def _featurize(self, wav_id: str):
        from scipy.io import wavfile
        p = self._params
        sr, signal = wavfile.read(self._wav_path(wav_id))
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        if signal.dtype.kind == "i":
            signal = signal / np.iinfo(signal.dtype).max
        out_type = p["output_type"]
        kwargs = dict(
            sample_freq=sr, n_fft=p["n_fft"],
            mag_power=p["mag_power"],
            feature_normalize=p["feature_normalize"],
            mean=p["feature_normalize_mean"],
            std=p["feature_normalize_std"],
            data_min=(p["data_min"] if isinstance(p["data_min"], float)
                      else 1e-5),
            trim=p["trim"], fmax=p.get("fmax"))
        if out_type == "both":
            mel, mag = get_speech_features_tts(
                signal, num_mels=self.n_feats["mel"],
                output_type="both", **kwargs)
            return mel, mag
        num = (self.n_feats.get("mel") or self.n_feats["magnitude"])
        spec = get_speech_features_tts(signal, num_mels=num,
                                       output_type=out_type, **kwargs)
        if out_type == "magnitude":
            spec = spec[:, :self.n_feats["magnitude"]]
        return spec, None

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        order = np.arange(len(self._rows))
        if p["shuffle"]:
            self._rng.shuffle(order)
        chunk: List = []
        for idx in order:
            row = self._rows[idx]
            text = row[-1] if len(row) > 2 else row[1]
            ex = {"idx": int(idx),
                  "text": self.encode_text(text.lower())}
            if p["mode"] != "infer":
                try:
                    spec, mag = self._featurize(row[0])
                except (OSError, FileNotFoundError):
                    continue
                dur = spec.shape[0]
                if p.get("duration_min") and dur < p["duration_min"]:
                    continue
                if p.get("duration_max") and dur > p["duration_max"]:
                    continue
                ex["spec"] = spec
                ex["mag"] = mag
            chunk.append(ex)
            if len(chunk) == B:
                yield self._collate(chunk, B)
                chunk = []
        if chunk:
            valid = len(chunk)
            chunk += [chunk[-1]] * (B - valid)
            yield self._collate(chunk, valid)

    def _collate(self, chunk, valid):
        p = self._params
        B = len(chunk)
        S = self.pad_to_multiple(max(len(e["text"]) for e in chunk), 8)
        text = np.zeros((B, S), np.int32)
        text_len = np.zeros((B,), np.int32)
        ids = np.zeros((B,), np.int32)
        for i, e in enumerate(chunk):
            text[i, :len(e["text"])] = e["text"]
            text_len[i] = len(e["text"])
            ids[i] = e["idx"]
        batch = {"source_tensors": [text, text_len],
                 "source_ids": ids,
                 "batch_valid": np.int32(valid)}
        if "spec" in chunk[0]:
            extra = 1 if p["pad_EOS"] else 0
            T = self.pad_to_multiple(
                max(e["spec"].shape[0] for e in chunk) + extra,
                p["pad_to"])
            F = chunk[0]["spec"].shape[1]
            spec = np.full((B, T, F), p["pad_value"], np.float32)
            stop = np.ones((B, T), np.float32)
            spec_len = np.zeros((B,), np.int32)
            for i, e in enumerate(chunk):
                t = e["spec"].shape[0]
                spec[i, :t] = e["spec"]
                stop[i, :t] = 0.0      # 0 = keep going, 1 = stop
                spec_len[i] = t + extra
            batch["target_tensors"] = [spec, stop, spec_len]
            if chunk[0].get("mag") is not None:
                Fm = chunk[0]["mag"].shape[1]
                mag = np.full((B, T, Fm), p["pad_value"], np.float32)
                for i, e in enumerate(chunk):
                    mag[i, :e["mag"].shape[0]] = e["mag"]
                batch["spec_mag"] = mag
        return batch

    def decode_ids(self, ids) -> str:
        return "".join(self.idx2char.get(int(i), "")
                       for i in np.asarray(ids).tolist()
                       if 0 <= int(i) < len(self.idx2char))

    def create_interactive_batch(self, model_in):
        """One line of text -> a single-example infer batch (the
        reference's interactive text-to-speech flow; ``run.py
        --mode=interactive_infer``)."""
        text = str(model_in).strip().lower()
        if not text:
            raise ValueError("empty text")
        return self._collate([{"idx": 0, "text": self.encode_text(text)}],
                             valid=1)
