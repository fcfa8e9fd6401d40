"""WaveNet data layer (port of
``openseq2seq_tpu/data/text2speech/text2speech_wavenet.py``, the same
batches): raw audio and its conditioning mel features from LJSpeech-style
CSVs.

In training a clip longer than ``num_samples`` (16,384 by default) is cut
to a chunk of that many samples whose start, drawn from the layer's
``RandomState`` in the JAX layer's order, is aligned down to a mel hop
(``n_fft // 4``). A batch holds
``source_tensors: [audio (B, T) fp32, audio_len (B,), mel (B, T_mel,
F)]`` and the audio again as ``target_tensors: [audio, audio_len]``, T
padded to a multiple of 256; the last batch is filled out by repeating
its last example (``batch_valid`` counts the real ones).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np

from .speech_utils import get_speech_features_tts
from .text2speech import Text2SpeechDataLayer


class WavenetDataLayer(Text2SpeechDataLayer):

    @staticmethod
    def get_optional_params():
        return dict(Text2SpeechDataLayer.get_optional_params(), **{
            "num_samples": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        params.setdefault("output_type", "mel")
        params.setdefault("feature_normalize", False)
        super().__init__(params, model, num_workers, worker_id)
        self._params.setdefault("num_samples", 16384)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        from scipy.io import wavfile
        p = self._params
        B = p["batch_size"]
        n_samples = p["num_samples"]
        hop = p["n_fft"] // 4
        order = np.arange(len(self._rows))
        if p["shuffle"]:
            self._rng.shuffle(order)
        chunk: List = []
        for idx in order:
            try:
                sr, signal = wavfile.read(self._wav_path(self._rows[idx][0]))
            except (OSError, FileNotFoundError):
                continue
            if signal.ndim > 1:
                signal = signal.mean(axis=1)
            if signal.dtype.kind == "i":
                signal = signal / np.iinfo(signal.dtype).max
            signal = signal.astype(np.float32)
            if p["mode"] == "train" and len(signal) > n_samples:
                start = self._rng.randint(0, len(signal) - n_samples)
                start = start // hop * hop   # aligned to mel frames
                signal = signal[start:start + n_samples]
            mel = get_speech_features_tts(
                signal, sr, n_fft=p["n_fft"],
                num_mels=(self.n_feats.get("mel") or 80),
                output_type="mel", mag_power=p["mag_power"])
            chunk.append({"idx": int(idx), "audio": signal, "mel": mel})
            if len(chunk) == B:
                yield self._collate_wavenet(chunk, B)
                chunk = []
        if chunk:
            valid = len(chunk)
            chunk += [chunk[-1]] * (B - valid)
            yield self._collate_wavenet(chunk, valid)

    def _collate_wavenet(self, chunk, valid):
        B = len(chunk)
        T = self.pad_to_multiple(max(len(e["audio"]) for e in chunk), 256)
        audio = np.zeros((B, T), np.float32)
        audio_len = np.zeros((B,), np.int32)
        Tm = max(e["mel"].shape[0] for e in chunk)
        mel = np.zeros((B, Tm, chunk[0]["mel"].shape[1]), np.float32)
        ids = np.zeros((B,), np.int32)
        for i, e in enumerate(chunk):
            audio[i, :len(e["audio"])] = e["audio"]
            audio_len[i] = len(e["audio"])
            mel[i, :e["mel"].shape[0]] = e["mel"]
            ids[i] = e["idx"]
        return {"source_tensors": [audio, audio_len, mel],
                "target_tensors": [audio, audio_len],
                "source_ids": ids,
                "batch_valid": np.int32(valid)}
