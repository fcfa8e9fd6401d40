"""Text-to-speech task model (port of
``openseq2seq_tpu/models/text2speech.py``: ``Text2Speech`` and
``Text2SpeechTacotron``): the encoder's vocabulary and the decoder's
spectrogram width from the data layer, the spectrogram loss, "Validation
loss" with the attention's sharpness (the mean of each step's largest
alignment weight) in eval, with the first example's alignment as a PNG
where matplotlib imports and its Griffin-Lim audio, and in infer one int16
wav per example beside the output file, which lists them.

The prenet's dropout stays on outside training: eval and infer draw its
masks from a generator seeded with ``random_seed`` for each batch, as the
JAX model passes every eval batch the same fixed key.
``Text2SpeechCentaur`` rides the same evaluate and infer.
``Text2SpeechWavenet`` is the vocoder's: the loss alone in eval
("Validation loss"), the teacher-forced reconstruction in infer (one
``wavenet_<id>.wav`` an example beside the output file), and
:meth:`Text2SpeechWavenet.generate`, the fast autoregressive synthesis.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..utils.logging import deco_print

from ..data.text2speech.speech_utils import griffin_lim, inverse_mel
from .encoder_decoder import EncoderDecoderModel, ForwardPass


class Text2Speech(EncoderDecoderModel):

    def _create_encoder(self):
        enc_cls = self._params["encoder"]
        accepts = {**enc_cls.get_required_params(),
                   **enc_cls.get_optional_params()}
        self._params.setdefault("encoder_params", {})
        if "src_vocab_size" in accepts:
            self._params["encoder_params"].setdefault(
                "src_vocab_size",
                self.get_data_layer().params["src_vocab_size"])
        return super()._create_encoder()

    def _create_decoder(self):
        dec_cls = self._params["decoder"]
        accepts = {**dec_cls.get_required_params(),
                   **dec_cls.get_optional_params()}
        self._params.setdefault("decoder_params", {})
        if "num_audio_features" in accepts:
            self._params["decoder_params"].setdefault(
                "num_audio_features",
                self.get_data_layer().params["num_output_features"])
        return super()._create_decoder()

    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> ForwardPass:
        """The encoder takes the spectrogram's width (its style encoder
        reads spectrograms); the decoder the encoder's output width."""
        width = self.get_data_layer().params["num_output_features"]
        enc = self._encoder.make_module(width, generator)
        dec = self._decoder.make_module(enc.out_features, generator)
        return ForwardPass(enc, dec)

    def compute_loss(self, outputs, batch):
        return self._loss_computator.compute_loss({
            "decoder_output": outputs["decoder_output"],
            "target_tensors": batch["target_tensors"]})

    def eval_generator(self) -> torch.Generator:
        """The prenet's dropout stays on outside training: its masks come
        from a generator seeded with ``random_seed`` for each batch."""
        return torch.Generator(device=self.device).manual_seed(
            self._params.get("random_seed", 0))

    def evaluate(self, input_values, output_values):
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        loss = float(output_values.get("loss", 0.0))
        dec = output_values["outputs"]["decoder_output"]
        align = np.asarray(dec["alignments"])[:valid]
        sharpness = float(np.mean(np.max(align, axis=-1)))
        spec, spec_lens = dec["outputs"]
        n = int(np.asarray(spec_lens)[0])
        first_spec = np.asarray(spec)[0, :max(n, 1)]
        return (loss * valid, valid, sharpness, align[0], first_spec)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        total_loss = sum(r[0] for r in results_per_batch)
        total = sum(r[1] for r in results_per_batch)
        sharp = np.mean([r[2] for r in results_per_batch])
        eval_loss = total_loss / max(total, 1)
        deco_print("Validation loss: {:.4f} (attention sharpness "
                   "{:.3f})".format(eval_loss, sharp), offset=4)
        metrics = {"eval_loss": eval_loss,
                   "attention_sharpness": float(sharp)}
        first = results_per_batch[0][3] if results_per_batch else None
        if first is not None:
            try:
                from ..utils.tb_writer import plot_to_png
                metrics["image/attention_alignment"] = plot_to_png(
                    first.T, xlabel="decoder step", ylabel="encoder step")
            except Exception:
                pass
        first_spec = results_per_batch[0][4] if results_per_batch else None
        if first_spec is not None and first_spec.shape[0] > 1:
            try:
                wav = self.synthesize_wav(first_spec)
                peak = float(np.max(np.abs(wav))) or 1.0
                sr = self.get_data_layer().params.get("sample_freq", 22050)
                metrics["audio/synthesized"] = (wav / peak * 0.9, sr)
            except Exception:
                pass
        return metrics

    def synthesize_wav(self, spec: np.ndarray) -> np.ndarray:
        """A log spectrogram (T, F) -> waveform by Griffin-Lim."""
        dl = self.get_data_layer()
        p = dl.params
        n_fft = p.get("n_fft", 1024)
        sr = p.get("sample_freq", 22050)
        if p["output_type"] in ("mel", "both"):
            num_mels = (dl.n_feats["mel"] if hasattr(dl, "n_feats")
                        else p["num_audio_features"])
            mag = inverse_mel(
                spec, sr, n_fft, num_mels,
                mag_power=p.get("mag_power", 1),
                feature_normalize=p["feature_normalize"],
                mean=p.get("feature_normalize_mean", 0.0),
                std=p.get("feature_normalize_std", 1.0),
                fmax=p.get("fmax"))
        else:
            mag_log = spec
            if p["feature_normalize"]:
                mag_log = mag_log * p.get("feature_normalize_std", 1.0) + \
                    p.get("feature_normalize_mean", 0.0)
            full = n_fft // 2 + 1
            if mag_log.shape[1] < full:
                pad = np.full((mag_log.shape[0], full - mag_log.shape[1]),
                              np.log(1e-5), mag_log.dtype)
                mag_log = np.concatenate([mag_log, pad], axis=1)
            mag = np.exp(mag_log) ** (1.0 / p.get("mag_power", 1))
        return griffin_lim(mag, n_fft=n_fft)

    def infer(self, input_values, output_values):
        dec = output_values["outputs"]["decoder_output"]
        spec, lengths = dec["outputs"]
        valid = int(input_values.get("batch_valid", np.shape(spec)[0]))
        ids = np.asarray(input_values["source_ids"])[:valid]
        return [(int(ids[i]), np.asarray(spec)[i, :int(lengths[i])])
                for i in range(valid)]

    def finalize_inference(self, results_per_batch, output_file):
        """One int16 wav per example, ``sample_<id>.wav`` beside
        ``output_file``, which lists ``<id>,<wav path>`` in id order."""
        from scipy.io import wavfile
        out_dir = os.path.dirname(os.path.abspath(output_file)) or "."
        os.makedirs(out_dir, exist_ok=True)
        sr = self.get_data_layer().params.get("sample_freq", 22050)
        rows = [item for batch in results_per_batch for item in batch]
        rows.sort(key=lambda kv: kv[0])
        with open(output_file, "w") as f:
            for idx, spec in rows:
                wav = self.synthesize_wav(spec)
                wav_path = os.path.join(out_dir,
                                        "sample_{}.wav".format(idx))
                peak = np.max(np.abs(wav)) or 1.0
                wavfile.write(wav_path, sr,
                              (wav / peak * 0.9 * 32767).astype(np.int16))
                f.write("{},{}\n".format(idx, wav_path))
        deco_print("Synthesized {} wavs into {}".format(len(rows), out_dir))

    def get_num_objects_per_step(self, batch):
        """Spectrogram frames (text rows in infer)."""
        if "target_tensors" in batch:
            return int(np.sum(np.asarray(batch["target_tensors"][2])))
        return int(batch["source_tensors"][0].shape[0])


class Text2SpeechTacotron(Text2Speech):
    """The named subclass of the configs."""


class Text2SpeechCentaur(Text2Speech):
    """The named subclass of the configs: Centaur's alignments ride the
    same ``alignments`` output that evaluate plots."""


class Text2SpeechWavenet(Text2Speech):
    """The WaveNet vocoder: the encoder emits the logits, a
    ``FakeDecoder`` passes them through."""

    def _create_decoder(self):
        self._params.setdefault("decoder_params", {})
        return super(Text2Speech, self)._create_decoder()

    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> ForwardPass:
        """The encoder takes the conditioning's width (None without)."""
        src = example_batch["source_tensors"]
        enc = self._encoder.make_module(
            src[2].shape[-1] if len(src) > 2 else None, generator)
        dec = self._decoder.make_module(enc.out_features, generator)
        return ForwardPass(enc, dec)

    def generate(self, state, conditioning=None, n_samples: int = 16000,
                 temperature: float = 0.0,
                 generator: torch.Generator = None) -> np.ndarray:
        """Autoregressive synthesis (``encoders/wavenet_encoder.
        wavenet_generate``); ``conditioning`` (B, T_mel, F) mel features.
        Returns the (B, n_samples) waveform."""
        from ..encoders.wavenet_encoder import wavenet_generate
        if conditioning is not None:
            conditioning = torch.as_tensor(np.asarray(conditioning),
                                           device=self.device)
        _, audio, _ = wavenet_generate(
            state.module.enc.net, n_samples, conditioning=conditioning,
            temperature=temperature, generator=generator)
        return audio.cpu().numpy()

    def compute_loss(self, outputs, batch):
        return self._loss_computator.compute_loss({
            "decoder_output": outputs["decoder_output"],
            "target_tensors": batch.get("target_tensors")})

    def evaluate(self, input_values, output_values):
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        return (float(output_values.get("loss", 0.0)) * valid, valid)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        total = sum(r[0] for r in results_per_batch)
        count = sum(r[1] for r in results_per_batch)
        eval_loss = total / max(count, 1)
        deco_print("Validation loss: {:.4f}".format(eval_loss), offset=4)
        return {"eval_loss": eval_loss}

    def infer(self, input_values, output_values):
        audio = np.asarray(
            output_values["outputs"]["decoder_output"]["outputs"][1])
        valid = int(input_values.get("batch_valid", audio.shape[0]))
        ids = np.asarray(input_values["source_ids"])[:valid]
        return [(int(ids[i]), audio[i]) for i in range(valid)]

    def finalize_inference(self, results_per_batch, output_file):
        """One int16 wav an example, ``wavenet_<id>.wav`` beside
        ``output_file``, which lists ``<id>,<wav path>``."""
        from scipy.io import wavfile
        out_dir = os.path.dirname(os.path.abspath(output_file)) or "."
        os.makedirs(out_dir, exist_ok=True)
        sr = self.get_data_layer().params.get("sample_freq", 22050)
        rows = [item for batch in results_per_batch for item in batch]
        with open(output_file, "w") as f:
            for idx, wav in rows:
                path = os.path.join(out_dir, "wavenet_{}.wav".format(idx))
                peak = float(np.max(np.abs(wav))) or 1.0
                wavfile.write(path, sr,
                              (wav / peak * 0.9 * 32767).astype(np.int16))
                f.write("{},{}\n".format(idx, path))
        deco_print("Synthesized {} wavs".format(len(rows)))

    def get_num_objects_per_step(self, batch):
        """Audio samples."""
        return int(np.sum(np.asarray(batch["source_tensors"][1])))
