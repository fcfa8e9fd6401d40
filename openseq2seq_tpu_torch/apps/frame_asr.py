"""Streaming frame-by-frame ASR (port of
``openseq2seq_tpu/apps/frame_asr.py``; reference `frame_asr.py:40-311`
and `demo_streaming_asr.py`).

:class:`FrameASR` keeps a buffer of ``frame_len`` seconds of audio with
``frame_overlap`` seconds of context on each side, filled at the start
with seeded comfort noise. Each new frame shifts the buffer; if the
centre's energy clears ``silence_threshold``, the buffer is tapered (50
ms ramps), featurized on the host, run through the model's eval forward,
and the logits of the central region go to one of three decoders: the
greedy merge, the host ``BeamDecoder`` of ``ops/ctc_beam.py`` (native
when its library is built; optionally with an ARPA ``Scorer``), or the
prefix beam of ``ops/ctc_beam_device.py`` carried across chunks on the
model's device (``on_device_beam``, optionally fused with a
``FusionLM``).

The JAX package jits one fixed-shape forward; here the eval forward runs
under ``torch.inference_mode()`` at the one buffer shape, so cuDNN
autotunes its convs once. The weights come from the port's
``restore_state``.

:class:`TransducerFrameASR` decodes an RNN-T model over the same buffer,
its prediction net's carry and the emission frames threaded through the
transducer decoder's ``decode_carry``, ``decode_window`` and
``emit_frames``; the carry stays on the model's device between chunks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.ctc_beam import BeamDecoder, Scorer, group_word_timestamps
from ..ops.features import get_speech_features
from ..training.trainer import restore_state, to_host


class FrameASR:

    def __init__(self, model, checkpoint: Optional[str] = None,
                 sr: int = 16000, frame_len: float = 0.2,
                 frame_overlap: float = 2.4,
                 timestep_duration: float = 0.02, merge: bool = True,
                 beam_width: int = 1,
                 language_model: Optional[str] = None,
                 alpha: float = 2.8, beta: float = 1.0,
                 offset: int = 5, silence_threshold: float = 0.02,
                 comfort_noise: float = 1e-3,
                 on_device_beam: bool = False,
                 device_fusion=None, max_transcript_len: int = 400):
        """``model`` is a Speech2Text model built in "interactive_infer"
        (or eval) mode; ``timestep_duration`` is seconds a logit frame
        (the feature hop times the encoder's time stride)."""
        self.model = model
        self.state = restore_state(model, checkpoint)
        dl_params = model.get_data_layer().params
        self.vocab = [dl_params["idx2char"][i]
                      for i in range(len(dl_params["idx2char"]))]
        self.sr = sr
        self.frame_len = frame_len
        self.n_frame_len = int(frame_len * sr)
        self.n_frame_overlap = int(frame_overlap * sr)
        if self.n_frame_overlap % self.n_frame_len:
            raise ValueError("'frame_overlap' should be a multiple of "
                             "'frame_len'")
        self.n_timesteps_overlap = int(round(frame_overlap /
                                             timestep_duration))
        self.n_timesteps_frame = int(round(frame_len / timestep_duration))
        self.buffer = np.zeros(2 * self.n_frame_overlap + self.n_frame_len,
                               np.float32)
        self.merge = merge
        self.offset = offset
        self.silence_threshold = silence_threshold
        # digital-zero padding featurizes to the log floor, far outside
        # anything the model saw: pad with a real noise floor
        self.comfort_noise = comfort_noise
        self._noise_rng = np.random.RandomState(0)
        self._beam_decoder = None
        self._dev_beam = False
        if beam_width > 1 and on_device_beam:
            self._dev_K = beam_width
            self._dev_U = int(max_transcript_len)
            self._dev_fusion = device_fusion
            self._dev_beam = True
        elif beam_width > 1:
            scorer = None
            if language_model is not None:
                scorer = Scorer(alpha, beta, language_model, self.vocab)
            self._beam_decoder = BeamDecoder(self.vocab, beam_width,
                                             ext_scorer=scorer)
        self.reset()

    # ------------------------------------------------------------------
    def _noise(self, n):
        return (self._noise_rng.randn(n) *
                self.comfort_noise).astype(np.float32)

    def reset(self):
        self.buffer[:] = self._noise(len(self.buffer))
        self.text = ""
        self.prev_char = ""
        if self._beam_decoder is not None:
            self._beam_decoder.reset()
        if self._dev_beam:
            from ..ops.ctc_beam_device import ctc_beam_init
            self._dev_state = ctc_beam_init(1, self._dev_K, self._dev_U,
                                            self._dev_fusion,
                                            self.model.device)
            self._dev_times = []

    def _featurize(self, signal: np.ndarray):
        dl_params = dict(self.model.get_data_layer().params)
        feats, _ = get_speech_features(signal, self.sr, dl_params)
        return feats

    def _run_model(self, signal: np.ndarray, extra=None):
        """Taper and featurize ``signal``, run the eval forward; returns
        the decoder's output dict, its tensors on the model's device.
        ``extra`` joins the batch (the streaming decoders' state)."""
        # 50 ms ramps at the buffer's edges: audio cut mid-phoneme
        # splatters a spectrum the acoustic model never saw in training
        ramp = int(0.05 * self.sr)
        if len(signal) > 2 * ramp:
            signal = signal.copy()
            win = 0.5 * (1 - np.cos(np.pi * np.arange(ramp) / ramp))
            signal[:ramp] *= win
            signal[-ramp:] *= win[::-1]
        feats = self._featurize(signal)
        dl = self.model.get_data_layer()
        pad_to = max(dl.params.get("pad_to", 8), 1)
        T = dl.pad_to_multiple(feats.shape[0], pad_to)
        x = np.zeros((1, T, feats.shape[1]), np.float32)
        x[0, :feats.shape[0]] = feats
        batch = {"source_tensors": [x, np.asarray([feats.shape[0]],
                                                  np.int32)],
                 "source_ids": np.zeros((1,), np.int32),
                 "batch_valid": np.int32(1)}
        if extra:
            batch.update(extra)
        with torch.inference_mode():
            out = self.model.eval_step(self.state, batch)
        return out["outputs"]["decoder_output"]

    def _device_logits(self, signal: np.ndarray) -> torch.Tensor:
        """The (n, V) logits of ``signal``'s valid frames, on the model's
        device."""
        dec_out = self._run_model(signal)
        n = int(dec_out["src_length"][0])
        return dec_out["logits"][0, :n]

    def _infer_logits(self, signal: np.ndarray) -> np.ndarray:
        return to_host(self._device_logits(signal))

    # ------------------------------------------------------------------
    def transcribe(self, frame: np.ndarray) -> str:
        """Feed ``frame_len`` seconds of audio; returns the newly decoded
        text (greedy) or the whole current transcript (the beams)."""
        if len(frame) != self.n_frame_len:
            raise ValueError("frame must be exactly frame_len seconds")
        self.buffer[:-self.n_frame_len] = self.buffer[self.n_frame_len:]
        self.buffer[-self.n_frame_len:] = frame
        # energy gate: the buffer's gain normalization would amplify the
        # noise of a silent centre into phantom phones
        central_audio = self.buffer[self.n_frame_overlap:
                                    self.n_frame_overlap +
                                    self.n_frame_len]
        if np.sqrt(np.mean(central_audio ** 2)) < self.silence_threshold:
            self.prev_char = ""
            return ""
        # exactly the central frame_len region, so that consecutive
        # windows tile without duplicates or gaps
        lo = self.n_timesteps_overlap
        if self._dev_beam:
            return self._device_beam_step(
                self._device_logits(self.buffer)[
                    lo:lo + self.n_timesteps_frame])
        logits = self._infer_logits(self.buffer)
        probs = _softmax(logits[lo:lo + self.n_timesteps_frame])
        if self._beam_decoder is not None:
            # self.text follows the decoder's transcript, for flush()'s
            # fallback when every flush frame is silence-gated
            self.text = self._beam_decoder.decode(probs)
            return self.text
        return self._greedy_merge_step(probs)

    def _device_beam_step(self, central: torch.Tensor) -> str:
        from ..ops.ctc_beam_device import ctc_beam_update
        n = central.shape[0]
        with torch.inference_mode():
            self._dev_state, (ids, lens, _, frames) = ctc_beam_update(
                self._dev_state, central[None],
                torch.tensor([n], dtype=torch.int32, device=central.device),
                fusion=self._dev_fusion)
        n_len = int(lens[0, 0])
        best = ids[0, 0, :n_len].tolist()
        self.text = "".join(self.vocab[int(i)] for i in best)
        self._dev_times = frames[0, 0, :n_len].tolist()
        return self.text

    def _greedy_merge_step(self, probs: np.ndarray) -> str:
        blank = probs.shape[1] - 1
        ids = np.argmax(probs, axis=1)
        out = []
        for i in ids:
            ch = "" if i == blank else self.vocab[int(i)]
            if ch and ch != self.prev_char:
                out.append(ch)
            self.prev_char = ch if i != blank else ""
        new_text = "".join(out)
        self.text += new_text
        return new_text

    def flush(self) -> str:
        """Feed comfort noise until the tail of the audio has passed the
        central (decoded) region. Greedy: the newly produced text (join
        it to what came before); the beams: the whole final transcript,
        as ``transcribe`` returns there."""
        out = []
        frames = self.n_frame_overlap // self.n_frame_len + 1
        for _ in range(frames):
            out.append(self.transcribe(self._noise(self.n_frame_len)))
        if self._beam_decoder is not None or self._dev_beam:
            full = [t for t in out if t]
            return full[-1] if full else self.text
        return "".join(out)

    def get_word_timestamps(self):
        """[(word, start_frame, end_frame)] from either beam: the host
        decoder's emission times or the device beam's carried emission
        frames (utterance-absolute, grouped the same way)."""
        if self._dev_beam:
            return group_word_timestamps(self.text,
                                         getattr(self, "_dev_times", []))
        if self._beam_decoder is None:
            return []
        return self._beam_decoder.get_word_timestamps()


class TransducerFrameASR(FrameASR):
    """Streaming RNN-T decoding over :class:`FrameASR`'s buffer.

    The prediction net's state (the LSTM carry and its projected output)
    goes from chunk to chunk through the decoder's ``decode_carry`` and
    ``decode_window``, and each encoder frame of the central region is
    consumed once, so there is no merge step and no duplicate emission at
    a window's edge; the encoder still sees the overlap on both sides.

    ``timestep_duration`` includes the encoder's time stride (10 ms hop x
    4 for the Conformer's subsampling: 0.04)."""

    def __init__(self, model, checkpoint: Optional[str] = None, **kwargs):
        for k in ("merge", "beam_width", "language_model", "alpha",
                  "beta", "offset"):
            kwargs.pop(k, None)
        super().__init__(model, checkpoint, merge=False, beam_width=1,
                         **kwargs)

    def reset(self):
        super().reset()
        self._carry = None
        self._frames_done = 0   # decoded central frames consumed so far
        self._times = []        # each emitted character's frame

    def transcribe(self, frame: np.ndarray) -> str:
        """Feed ``frame_len`` seconds of audio; returns the text newly
        emitted for the buffer's central region."""
        if len(frame) != self.n_frame_len:
            raise ValueError("frame must be exactly frame_len seconds")
        self.buffer[:-self.n_frame_len] = self.buffer[self.n_frame_len:]
        self.buffer[-self.n_frame_len:] = frame
        central_audio = self.buffer[self.n_frame_overlap:
                                    self.n_frame_overlap +
                                    self.n_frame_len]
        if np.sqrt(np.mean(central_audio ** 2)) < self.silence_threshold:
            return ""
        lo = np.asarray([self.n_timesteps_overlap], np.int32)
        hi = lo + np.int32(self.n_timesteps_frame)
        extra = {"decode_window": (lo, hi)}
        if self._carry is not None:
            extra["decode_carry"] = self._carry
        dec_out = self._run_model(self.buffer, extra=extra)
        self._carry = dec_out["decode_carry"]
        ids, n = dec_out["outputs"]
        n = int(n[0])
        ids = ids[0, :n].tolist()
        new_text = "".join(self.vocab[int(i)] for i in ids)
        # emission frames are the buffer's; rebased onto the running
        # count of consumed central frames (timestamps count decoded,
        # not silence-gated, frames, as the CTC streaming decoders do)
        emit = dec_out["emit_frames"][0, :n].tolist()
        self._times.extend(self._frames_done + int(t) - int(lo[0])
                           for t in emit)
        self._frames_done += self.n_timesteps_frame
        self.text += new_text
        return new_text

    def get_word_timestamps(self):
        """[(word, start_frame, end_frame)]: RNN-T emissions are frame
        synchronous, so these come straight from the decoder."""
        return group_word_timestamps(self.text, self._times)


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
