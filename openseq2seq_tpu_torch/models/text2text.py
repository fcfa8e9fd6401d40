"""Text-to-text (NMT) task model: the loss on shifted targets, BLEU in
eval, the detokenized infer file, the training samples (port of
``openseq2seq_tpu/models/text2text.py``). Train, eval and infer are
ported.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils.logging import deco_print
from ..utils.metrics import corpus_bleu

from .encoder_decoder import EncoderDecoderModel


class Text2Text(EncoderDecoderModel):

    def _create_encoder(self):
        self._params.setdefault("encoder_params", {})
        self._params["encoder_params"].setdefault(
            "src_vocab_size", self.get_data_layer().params["src_vocab_size"])
        return super()._create_encoder()

    def _create_decoder(self):
        dl_params = self.get_data_layer().params
        self._params.setdefault("decoder_params", {})
        dp = self._params["decoder_params"]
        dp.setdefault("tgt_vocab_size", dl_params["tgt_vocab_size"])
        dp.setdefault("batch_size", dl_params["batch_size"])
        return super()._create_decoder()

    def _create_loss(self):
        if self._params.get("loss") is not None:
            self._params.setdefault("loss_params", {})
            lp = self._params["loss_params"]
            accepts = {**self._params["loss"].get_required_params(),
                       **self._params["loss"].get_optional_params()}
            dl_params = self.get_data_layer().params
            if "tgt_vocab_size" in accepts:
                lp.setdefault("tgt_vocab_size", dl_params["tgt_vocab_size"])
            if "batch_size" in accepts:
                lp.setdefault("batch_size", dl_params["batch_size"])
        return super()._create_loss()

    def compute_loss(self, outputs, batch):
        """The decoder's logits predict y[t+1] from y[<=t]: the loss sees
        the targets shifted by one, here and only here. ``targets_aligned``
        keeps a loss's ``offset_target_by_one`` from shifting them again,
        as the JAX package's losses do (C22: there logits[t] are scored
        against y[t + 2])."""
        y, y_len = batch["target_tensors"]
        return self._loss_computator.compute_loss({
            "decoder_output": outputs["decoder_output"],
            "target_tensors": [y[:, 1:], y_len - 1],
            "targets_aligned": True,
        })

    def _decode_batch(self, output_values) -> List[str]:
        ids, lengths = output_values
        dl = self.get_data_layer()
        return [dl.decode_ids(row[:int(n)])
                for row, n in zip(np.asarray(ids), np.asarray(lengths))]

    def print_samples(self, input_values, output_values, step):
        """The first sentence's source, target and prediction
        (``text2text.py:61-75``); nothing when the decoder output has no
        decoded ``outputs``."""
        dec_out = output_values["outputs"]["decoder_output"]
        if "outputs" not in dec_out:
            return
        dl = self.get_data_layer()
        x, x_len = input_values["source_tensors"][:2]
        y, y_len = input_values["target_tensors"][:2]
        src = dl.decode_ids(x[0][:int(x_len[0])], side="src")
        ref = dl.decode_ids(y[0][:int(y_len[0])])
        hyp = self._decode_batch(dec_out["outputs"])[0]
        deco_print("Sample source:     {}".format(src), offset=4)
        deco_print("Sample target:     {}".format(ref), offset=4)
        deco_print("Sample prediction: {}".format(hyp), offset=4)

    def evaluate(self, input_values, output_values):
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        dec_out = output_values["outputs"]["decoder_output"]
        hyps = self._decode_batch(dec_out["outputs"])[:valid]
        y, y_len = input_values["target_tensors"]
        refs = [self.get_data_layer().decode_ids(y[i][:int(y_len[i])])
                for i in range(valid)]
        loss = float(output_values.get("loss", 0.0))
        return (refs, hyps, loss * valid, valid)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        refs, hyps = [], []
        total_loss, total_count = 0.0, 0
        for r, h, l, c in results_per_batch:
            refs.extend(r)
            hyps.extend(h)
            total_loss += l
            total_count += c
        bleu = corpus_bleu([r.split() for r in refs],
                           [h.split() for h in hyps], smooth=True)
        eval_loss = total_loss / max(total_count, 1)
        deco_print("Validation BLEU: {:.4f}".format(bleu * 100), offset=4)
        return {"Eval BLEU": bleu * 100, "eval_loss": eval_loss}

    def infer(self, input_values, output_values):
        dec_out = output_values["outputs"]["decoder_output"]
        hyps = self._decode_batch(dec_out["outputs"])
        valid = int(input_values.get("batch_valid", len(hyps)))
        ids = np.asarray(input_values["source_ids"])[:valid]
        return list(zip(ids.tolist(), hyps[:valid]))

    def finalize_inference(self, results_per_batch, output_file):
        rows = [item for batch in results_per_batch for item in batch]
        rows.sort(key=lambda kv: kv[0])
        with open(output_file, "w", encoding="utf-8") as f:
            for _, text in rows:
                f.write(text + "\n")
        deco_print("Predictions saved to {}".format(output_file))

    def get_num_objects_per_step(self, batch):
        """Source plus target tokens (``_get_num_objects_per_step``)."""
        n = int(np.sum(np.asarray(batch["source_tensors"][1])))
        if "target_tensors" in batch:
            n += int(np.sum(np.asarray(batch["target_tensors"][1])))
        return n
