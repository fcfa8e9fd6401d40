"""Image classification task model: top-1 and top-5 accuracy, the infer
csv and images per step (port of ``openseq2seq_tpu/models/image2label.py``).
It also runs the speech-commands classifiers, whose "images" are log-mel
spectrograms (``data/speech2text/speech_commands.py``).

The encoder's output width reaches the decoder from the example batch:
the image encoders (``ResNetEncoder``, ``CNNEncoder``) take the image's
(H, W, C) and give their output shape; any other encoder (the TDNN of
``jasper_speech_commands.py``) takes the channel count and is run once on
one zero example on the host to read its output's shape.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.logging import deco_print

from .encoder_decoder import EncoderDecoderModel, ForwardPass


class Image2Label(EncoderDecoderModel):

    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> ForwardPass:
        src = example_batch["source_tensors"]
        shape = tuple(np.asarray(src[0]).shape[1:])
        if getattr(self._encoder, "takes_image_shape", False):
            enc = self._encoder.make_module(shape, generator)
            out_shape = enc.out_shape
        else:
            enc = self._encoder.make_module(shape[-1], generator)
            probe = [torch.zeros((1,) + shape)] + [
                torch.as_tensor(np.asarray(t)[:1]) for t in src[1:]]
            with torch.no_grad():
                out_shape = tuple(enc({"source_tensors": probe},
                                      False)["outputs"].shape[1:])
        width = self._decoder.input_width(out_shape, len(src) > 1)
        return ForwardPass(enc, self._decoder.make_module(width, generator))

    def evaluate(self, input_values, output_values):
        """Per batch (top-1 hits, top-5 hits, count, loss sum) over the
        valid slice."""
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        logits = np.asarray(
            output_values["outputs"]["decoder_output"]["logits"])[:valid]
        labels = np.asarray(input_values["target_tensors"][0])[:valid]
        if labels.ndim > 1:
            labels = np.argmax(labels, axis=-1)
        top1 = int(np.sum(np.argmax(logits, axis=-1) == labels))
        top5_idx = np.argsort(logits, axis=-1)[:, -5:]
        top5 = int(np.sum(top5_idx == labels[:, None]))
        loss = float(output_values.get("loss", 0.0))
        return (top1, top5, valid, loss * valid)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        top1 = sum(r[0] for r in results_per_batch)
        top5 = sum(r[1] for r in results_per_batch)
        total = sum(r[2] for r in results_per_batch)
        loss = sum(r[3] for r in results_per_batch)
        metrics = {"Eval top-1": top1 / max(total, 1),
                   "Eval top-5": top5 / max(total, 1),
                   "eval_loss": loss / max(total, 1)}
        deco_print("Validation top-1: {:.4f}, top-5: {:.4f}".format(
            metrics["Eval top-1"], metrics["Eval top-5"]), offset=4)
        return metrics

    def infer(self, input_values, output_values):
        logits = np.asarray(
            output_values["outputs"]["decoder_output"]["logits"])
        valid = int(input_values.get("batch_valid", logits.shape[0]))
        ids = np.asarray(input_values["source_ids"])[:valid]
        preds = np.argmax(logits[:valid], axis=-1)
        return list(zip(ids.tolist(), preds.tolist()))

    def finalize_inference(self, results_per_batch, output_file):
        rows = [item for batch in results_per_batch for item in batch]
        rows.sort(key=lambda kv: kv[0])
        with open(output_file, "w") as f:
            f.write("sample_id,predicted_label\n")
            for idx, pred in rows:
                f.write("{},{}\n".format(idx, pred))
        deco_print("Predictions saved to {}".format(output_file))

    def get_num_objects_per_step(self, batch):
        """Images in the batch."""
        return int(batch["source_tensors"][0].shape[0])
