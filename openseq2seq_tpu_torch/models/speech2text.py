"""Speech-to-text task model: WER, the infer CSV, training samples and
frame counts (port of ``openseq2seq_tpu/models/speech2text.py``).

Infer writes one CSV row per utterance in the data layer's order: with
the wav data layer (``data/speech2text``) each row names its wav, as in
the JAX package, and with the synthetic layer, which has no files, its
index. With the decoder's ``infer_logits_to_pickle`` it instead pickles
``{wav: logits[:length]}``, (T, V) fp32 numpy arrays, which the host
beam search with a language model reads (``scripts_torch/decode.py``).

The loss's ``tgt_vocab_size`` and ``batch_size`` are filled in from the
data layer where the loss class accepts them and the config leaves them
out (the joint CTC-attention loss requires both).

With the data layer's ``featurize_on_device`` the batches hold padded raw
audio and the forward pass begins with the log-mel features of
``ops/features_device.py``, on the model's device, with the data layer's
featurization parameters; the encoder and decoder then sit under
``inner``, the name the JAX package's wrapping flax module gives them.
"""
from __future__ import annotations

import csv
import math
import pickle
from typing import Any, Dict, List

import numpy as np
import torch

from ..utils.logging import deco_print
from ..utils.metrics import levenshtein

from ..ops.features_device import logmel_features
from .encoder_decoder import EncoderDecoderModel


def featurize_params(dl_params: Dict[str, Any]) -> Dict[str, Any]:
    """``logmel_features``' keywords from a speech data layer's params,
    as the JAX package's model derives them (the host featurizer's
    defaults: 20 ms windows every 10 ms, the next power of two for the
    FFT, ``norm_per_feature`` False)."""
    sr = int(dl_params.get("sample_freq", 16000))
    window = dl_params.get("window_size", 20e-3)
    return {"sample_freq": sr, "win_length": int(window * sr),
            "hop_length": int(dl_params.get("window_stride", 10e-3) * sr),
            "n_fft": int(dl_params.get("num_fft", 0) or
                         2 ** math.ceil(math.log2(window * sr))),
            "num_features": int(dl_params["num_audio_features"]),
            "norm_per_feature": bool(dl_params.get("norm_per_feature",
                                                   False))}


class DeviceFeaturizedForward(torch.nn.Module):
    """The forward pass ``inner`` on log-mel features computed from the
    batch's raw audio (B, N) and its lengths."""

    def __init__(self, inner: torch.nn.Module, featurize: Dict[str, Any]):
        super().__init__()
        self.inner = inner
        self.featurize = featurize

    def forward(self, batch: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        audio, audio_len = batch["source_tensors"]
        feats, feat_len = logmel_features(audio, audio_len,
                                          **self.featurize)
        return self.inner(dict(batch, source_tensors=[feats, feat_len]),
                          train, generator)


class Speech2Text(EncoderDecoderModel):

    def _create_decoder(self):
        # the vocabulary size comes from the data layer
        self._params.setdefault("decoder_params", {})
        self._params["decoder_params"]["tgt_vocab_size"] = \
            self.get_data_layer().params["tgt_vocab_size"]
        return super()._create_decoder()

    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> torch.nn.Module:
        dlp = self.get_data_layer().params
        if not dlp.get("featurize_on_device", False):
            return super().build_module(example_batch, generator)
        featurize = featurize_params(dlp)
        # the encoder's input width is the features', not the samples'
        widths = {"source_tensors": [
            np.zeros((1, 1, featurize["num_features"]), np.float32)]}
        return DeviceFeaturizedForward(
            super().build_module(widths, generator), featurize)

    def _create_loss(self):
        loss_cls = self._params.get("loss")
        if loss_cls is not None:
            accepts = {**loss_cls.get_required_params(),
                       **loss_cls.get_optional_params()}
            self._params.setdefault("loss_params", {})
            dl_params = self.get_data_layer().params
            for key in ("tgt_vocab_size", "batch_size"):
                if key in accepts:
                    self._params["loss_params"].setdefault(key,
                                                           dl_params[key])
        return super()._create_loss()

    def _decode_batch(self, output_values) -> List[str]:
        """Decoded ids (B, T) and lengths -> list of transcripts."""
        ids, lengths = output_values
        return [self.get_data_layer().decode_ids(row[:int(n)])
                for row, n in zip(np.asarray(ids), np.asarray(lengths))]

    def evaluate(self, input_values: Dict[str, Any],
                 output_values: Dict[str, Any]):
        """Per-batch (edit distance, reference words, loss sum, count)
        over the valid slice of the batch."""
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        decoded = self._decode_batch(
            output_values["outputs"]["decoder_output"]["outputs"])[:valid]
        labels, label_lens = input_values["target_tensors"]
        total_dist, total_words = 0, 0
        for i in range(valid):
            ref = self.get_data_layer().decode_ids(
                labels[i][:int(label_lens[i])])
            total_dist += levenshtein(ref.split(), decoded[i].split())
            total_words += len(ref.split())
        return (total_dist, total_words,
                float(output_values.get("loss", 0.0)) * valid, valid)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        total_dist = sum(r[0] for r in results_per_batch)
        total_words = sum(r[1] for r in results_per_batch)
        total_loss = sum(r[2] for r in results_per_batch)
        total_count = sum(r[3] for r in results_per_batch)
        wer = total_dist / max(total_words, 1)
        eval_loss = total_loss / max(total_count, 1)
        deco_print("Validation WER: {:.4f}".format(wer), offset=4)
        return {"Eval WER": wer, "eval_loss": eval_loss}

    @property
    def _dump_logits(self) -> bool:
        return bool(self._params.get("decoder_params", {})
                    .get("infer_logits_to_pickle", False))

    def infer(self, input_values, output_values):
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        ids = np.asarray(input_values["source_ids"])[:valid]
        if self._dump_logits:
            dec = output_values["outputs"]["decoder_output"]
            logits = np.asarray(dec["logits"])
            lengths = np.asarray(dec["src_length"])
            return [(int(ids[i]), logits[i, :int(lengths[i])])
                    for i in range(valid)]
        decoded = self._decode_batch(
            output_values["outputs"]["decoder_output"]["outputs"])[:valid]
        return list(zip(ids.tolist(), decoded))

    def finalize_inference(self, results_per_batch, output_file):
        rows = [item for batch in results_per_batch for item in batch]
        rows.sort(key=lambda kv: kv[0])
        files = getattr(self.get_data_layer(), "all_files", ())
        if self._dump_logits:
            dumped = {(files[idx][0] if idx < len(files) else str(idx)):
                      logits for idx, logits in rows}
            with open(output_file, "wb") as f:
                pickle.dump(dumped, f)
            deco_print("Logits pickled to {}".format(output_file))
            return
        with open(output_file, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["wav_filename", "predicted_transcript"])
            for idx, text in rows:
                wav = files[idx][0] if idx < len(files) else str(idx)
                writer.writerow([wav, text])
        deco_print("Predictions saved to {}".format(output_file))

    def print_samples(self, input_values, output_values, step):
        """First-sample target against the greedy prediction, and its
        WER."""
        dec = output_values["outputs"]["decoder_output"]
        if "outputs" not in dec:
            return
        hyp = self._decode_batch(dec["outputs"])[0]
        labels, label_lens = input_values["target_tensors"]
        ref = self.get_data_layer().decode_ids(
            labels[0][:int(label_lens[0])])
        wer = levenshtein(ref.split(), hyp.split()) / \
            max(len(ref.split()), 1)
        deco_print("Sample WER: {:.4f}".format(wer), offset=4)
        deco_print("Sample target:     {}".format(ref), offset=4)
        deco_print("Sample prediction: {}".format(hyp), offset=4)

    def get_num_objects_per_step(self, batch):
        """Audio frames in the batch (of a raw-audio batch, the frames
        its samples make)."""
        lengths = np.asarray(batch["source_tensors"][1])
        if batch["source_tensors"][0].ndim == 2:
            hop = featurize_params(
                self.get_data_layer().params)["hop_length"]
            return int(np.sum(1 + lengths // hop))
        return int(np.sum(lengths))
