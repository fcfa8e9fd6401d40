"""Synthetic fixed-shape data layers (the port's copy of
``SyntheticSpeechDataLayer``, ``SyntheticTextDataLayer``,
``SyntheticLMDataLayer``, ``SyntheticTTSDataLayer`` and
``SyntheticImageDataLayer`` from
``openseq2seq_tpu/data/synthetic.py``,
unchanged in behaviour: the same seeds give the same batches, so the port
and the JAX package see the same data).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

from .data_layer import DataLayer


class SyntheticSpeechDataLayer(DataLayer):
    """Random (features, labels) batches with constant shapes."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "num_audio_features": int,
            "tgt_vocab_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "time_steps": int,
            "label_length": int,
            "num_batches": int,
            "vocab_file": str,      # parity keys, unused
            "dataset_files": list,
            "input_type": str,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("time_steps", 1000)
        p.setdefault("label_length", 128)
        p.setdefault("num_batches", 100)
        p.setdefault("batch_size", 8)
        # decode support for eval paths
        p["idx2char"] = {i: chr(ord("a") + i % 26)
                         for i in range(p["tgt_vocab_size"] - 1)}

    def get_size_in_samples(self) -> int:
        return self._params["num_batches"] * self._params["batch_size"]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B, T, F = p["batch_size"], p["time_steps"], p["num_audio_features"]
        L, V = p["label_length"], p["tgt_vocab_size"]
        rng = np.random.RandomState(self._params.get("mode") == "train" and 1 or 2)
        x = rng.randn(B, T, F).astype(np.float32)
        x_len = np.full((B,), T, np.int32)
        y = rng.randint(0, V - 1, size=(B, L)).astype(np.int32)
        y_len = np.full((B,), L, np.int32)
        batch = {"source_tensors": [x, x_len],
                 "target_tensors": [y, y_len],
                 "source_ids": np.arange(B, dtype=np.int32),
                 "batch_valid": np.int32(B)}
        for _ in range(p["num_batches"]):
            yield batch

    def decode_ids(self, ids):
        idx2char = self._params["idx2char"]
        return "".join(idx2char.get(int(i), "")
                       for i in np.asarray(ids).tolist() if int(i) >= 0)


class SyntheticTextDataLayer(DataLayer):
    """Random parallel-text batches with constant shapes, for NMT
    throughput benchmarking (same role as SyntheticSpeechDataLayer)."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "src_vocab_size": int,
            "tgt_vocab_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "src_length": int,
            "tgt_length": int,
            "num_batches": int,
            # fraction of each sequence that is PAD (0 = dense). Valid
            # lengths draw uniformly from [T(1-2f), T] (mean (1-f)T),
            # modeling within-bucket padding of a bucketed real corpus
            # so `remove_padding` has actual work to do in benchmarks
            "pad_fraction": float,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("src_length", 64)
        p.setdefault("tgt_length", 64)
        p.setdefault("num_batches", 100)
        p.setdefault("batch_size", 8)

    def get_size_in_samples(self) -> int:
        return self._params["num_batches"] * self._params["batch_size"]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        Ts, Tt = p["src_length"], p["tgt_length"]
        rng = np.random.RandomState(
            1 if self._params.get("mode") == "train" else 2)
        # ids 4.. leave room for PAD/EOS/GO specials (text2text.py:14-34)
        x = rng.randint(4, p["src_vocab_size"],
                        size=(B, Ts)).astype(np.int32)
        y = rng.randint(4, p["tgt_vocab_size"],
                        size=(B, Tt)).astype(np.int32)
        y[:, 0] = 2          # GO
        f = float(p.get("pad_fraction", 0.0) or 0.0)
        if f > 0.0:
            x_len = rng.randint(max(int(Ts * (1 - 2 * f)), 2), Ts + 1,
                                size=(B,)).astype(np.int32)
            y_len = rng.randint(max(int(Tt * (1 - 2 * f)), 3), Tt + 1,
                                size=(B,)).astype(np.int32)
            for i in range(B):
                x[i, x_len[i] - 1:] = 0
                x[i, x_len[i] - 1] = 1            # EOS then PADs
                y[i, y_len[i] - 1:] = 0
                y[i, y_len[i] - 1] = 1
        else:
            x_len = np.full((B,), Ts, np.int32)
            y_len = np.full((B,), Tt, np.int32)
            y[:, -1] = 1     # EOS
        batch = {"source_tensors": [x, x_len],
                 "target_tensors": [y, y_len],
                 "source_ids": np.arange(B, dtype=np.int32),
                 "batch_valid": np.int32(B)}
        for _ in range(p["num_batches"]):
            yield batch

    def decode_ids(self, ids, side: str = "tgt"):
        """Ids as text; ``side`` (the text layer's source or target
        vocabulary) is the same vocabulary here."""
        return " ".join(str(int(i)) for i in np.asarray(ids).tolist()
                        if int(i) >= 0)


class SyntheticLMDataLayer(DataLayer):
    """Random token tracks with the WKT batch contract
    (``data/lm/lmdata.py:131-146``): next-token-aligned (x, y) windows of
    ``bptt`` steps, for the LSTM language model."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "vocab_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "bptt": int,
            "num_batches": int,
            "end_token": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("bptt", 96)
        p.setdefault("num_batches", 100)
        p.setdefault("batch_size", 32)
        p.setdefault("end_token", 1)

    def get_size_in_samples(self) -> int:
        return self._params["num_batches"] * self._params["batch_size"]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B, T, V = p["batch_size"], p["bptt"], p["vocab_size"]
        rng = np.random.RandomState(
            1 if p.get("mode") == "train" else 2)
        track = rng.randint(0, V, size=(B, T + 1)).astype(np.int32)
        x, y = track[:, :-1], track[:, 1:]
        lengths = np.full((B,), T, np.int32)
        batch = {"source_tensors": [np.ascontiguousarray(x), lengths],
                 "target_tensors": [np.ascontiguousarray(y), lengths],
                 "source_ids": np.arange(B, dtype=np.int32),
                 "batch_valid": np.int32(B)}
        for _ in range(p["num_batches"]):
            yield batch

    def decode_ids(self, ids):
        return " ".join(str(int(i)) for i in np.asarray(ids).tolist()
                        if int(i) >= 0)


class SyntheticTTSDataLayer(DataLayer):
    """Random (text, mel spectrogram, stop target) batches with the
    Text2Speech collate contract (``data/text2speech/text2speech.py``),
    for Tacotron-2 at full width."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "src_vocab_size": int,
            "num_audio_features": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "text_length": int,
            "spec_length": int,
            "num_batches": int,
            "output_type": str,
            "feature_normalize": bool,
            "sample_freq": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("text_length", 96)
        p.setdefault("spec_length", 512)
        p.setdefault("num_batches", 100)
        p.setdefault("batch_size", 32)
        p.setdefault("output_type", "mel")
        p.setdefault("feature_normalize", False)
        # the Text2Speech model sizes the decoder's output from this
        p["num_output_features"] = p["num_audio_features"]

    def get_size_in_samples(self) -> int:
        return self._params["num_batches"] * self._params["batch_size"]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B, S = p["batch_size"], p["text_length"]
        T, F = p["spec_length"], p["num_audio_features"]
        rng = np.random.RandomState(
            1 if p.get("mode") == "train" else 2)
        text = rng.randint(1, p["src_vocab_size"],
                           size=(B, S)).astype(np.int32)
        text_len = np.full((B,), S, np.int32)
        spec = rng.randn(B, T, F).astype(np.float32)
        stop = np.zeros((B, T), np.float32)
        stop[:, -1] = 1.0
        spec_len = np.full((B,), T, np.int32)
        batch = {"source_tensors": [text, text_len],
                 "target_tensors": [spec, stop, spec_len],
                 "source_ids": np.arange(B, dtype=np.int32),
                 "batch_valid": np.int32(B)}
        for _ in range(p["num_batches"]):
            yield batch

    def decode_ids(self, ids):
        return " ".join(str(int(i)) for i in np.asarray(ids).tolist()
                        if int(i) >= 0)


class SyntheticImageDataLayer(DataLayer):
    """Random (image, label) batches with constant shapes, (B, S, S, 3)
    fp32 images and (B,) labels, for the image models at full width."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "num_classes": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "image_size": int,
            "num_batches": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("image_size", 224)
        p.setdefault("num_batches", 100)
        p.setdefault("batch_size", 32)

    def get_size_in_samples(self) -> int:
        return self._params["num_batches"] * self._params["batch_size"]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B, S, C = p["batch_size"], p["image_size"], p["num_classes"]
        rng = np.random.RandomState(
            1 if self._params.get("mode") == "train" else 2)
        x = rng.randn(B, S, S, 3).astype(np.float32)
        y = rng.randint(0, C, size=(B,)).astype(np.int32)
        batch = {"source_tensors": [x],
                 "target_tensors": [y],
                 "source_ids": np.arange(B, dtype=np.int32),
                 "batch_valid": np.int32(B)}
        for _ in range(p["num_batches"]):
            yield batch
