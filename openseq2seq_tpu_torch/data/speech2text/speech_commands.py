"""Google Speech Commands data layer (the port's copy of
``openseq2seq_tpu/data/speech2text/speech_commands.py``, unchanged in
behaviour: the same files and seed give the same batches): one-second
clips as log-mel "images", classified by keyword label.

CSV rows: ``<wav path relative to dataset_location>,<label index>``; rows
whose label is not a number (a header) are skipped. Each clip is cut or
zero-padded to one second at its own rate (as in the JAX package,
``audio_length`` does not change it), featurized as ``num_audio_features``
log filterbanks (``ops/features.py``), and in training with
``augment_data`` shifted by up to 100 ms and given noise at 0.005 of its
peak, both from the layer's seeded ``RandomState``. ``model_format``
"jasper" gives (B, T, F) features with their lengths; "resnet" cuts or
pads the frames to F, a square image, and adds a channel: (B, F, F, 1).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List

import numpy as np

from ..data_layer import DataLayer
from ...ops.features import get_speech_features


class SpeechCommandsDataLayer(DataLayer):

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "dataset_files": list,
            "dataset_location": str,
            "num_audio_features": int,
            "audio_length": int,
            "num_labels": int,
            "model_format": str,       # "jasper" (B,T,F) | "resnet" image
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "cache_data": bool,
            "augment_data": bool,
            "sample_freq": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 32)
        p.setdefault("sample_freq", 16000)
        rows: List = []
        for csv in p["dataset_files"]:
            with open(csv, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) >= 2 and parts[1].strip().isdigit():
                        rows.append((parts[0], int(parts[1])))
        if p["mode"] != "train" and num_workers > 1:
            n = len(rows)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            rows = rows[start:end]
        self._rows = rows
        # classification head size flows to the decoder like vocab size
        p["tgt_vocab_size"] = p["num_labels"]

    def get_size_in_samples(self) -> int:
        return len(self._rows)

    def _featurize(self, path: str, train: bool) -> np.ndarray:
        from scipy.io import wavfile
        p = self._params
        sr, signal = wavfile.read(os.path.join(p["dataset_location"],
                                               path))
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        signal = signal.astype(np.float32)
        L = sr  # 1-second clips (dataset convention)
        if train and p.get("augment_data", False):
            # random time shift +- 100ms and noise
            shift = self._rng.randint(-sr // 10, sr // 10)
            signal = np.roll(signal, shift)
            signal = signal + self._rng.randn(len(signal)) * \
                0.005 * np.max(np.abs(signal))
        if len(signal) < L:
            signal = np.pad(signal, (0, L - len(signal)))
        signal = signal[:L]
        feats, _ = get_speech_features(signal, sr, {
            "num_audio_features": p["num_audio_features"],
            "input_type": "logfbank",
            "sample_freq": sr,
        }, rng=self._rng)
        # fix the time dim so every example is the same "image" size
        T = p["num_audio_features"] if p["model_format"] == "resnet" \
            else feats.shape[0]
        if p["model_format"] == "resnet":
            # square image (F x F), crop/pad time
            if feats.shape[0] < T:
                feats = np.pad(feats, ((0, T - feats.shape[0]), (0, 0)))
            feats = feats[:T]
        return feats.astype(np.float32)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        train = p["mode"] == "train"
        order = np.arange(len(self._rows))
        if p["shuffle"]:
            self._rng.shuffle(order)
        feats_buf, labels, ids = [], [], []
        for idx in order:
            path, label = self._rows[idx]
            try:
                feats_buf.append(self._featurize(path, train))
            except (OSError, FileNotFoundError):
                continue
            labels.append(label)
            ids.append(idx)
            if len(feats_buf) == B:
                yield self._collate(feats_buf, labels, ids, B)
                feats_buf, labels, ids = [], [], []
        if feats_buf:
            valid = len(feats_buf)
            while len(feats_buf) < B:
                feats_buf.append(feats_buf[-1])
                labels.append(labels[-1])
                ids.append(ids[-1])
            yield self._collate(feats_buf, labels, ids, valid)

    def _collate(self, feats, labels, ids, valid):
        p = self._params
        T = max(f.shape[0] for f in feats)
        F = feats[0].shape[1]
        x = np.zeros((len(feats), T, F), np.float32)
        x_len = np.zeros((len(feats),), np.int32)
        for i, f in enumerate(feats):
            x[i, :f.shape[0]] = f
            x_len[i] = f.shape[0]
        if p["model_format"] == "resnet":
            x = x[..., None]        # (B, T, F, 1) image
        batch = {"source_tensors": [x, x_len],
                 "target_tensors": [np.asarray(labels, np.int32)],
                 "source_ids": np.asarray(ids, np.int32),
                 "batch_valid": np.int32(valid)}
        return batch
