"""LSTM language model task (port of ``openseq2seq_tpu/models/lstm_lm.py``):
perplexity on eval, argmax ids on infer, tokens as the objects of a step.

The encoder (``encoders/lm_encoders.py``) emits the logits, or in training
the sampled-softmax bundle, and ``FakeDecoder`` passes them through; the
loss defaults follow the JAX model (the data layer's vocabulary and batch
size, targets already next-token aligned, averaged over time).

:meth:`LSTMLM.eval_step` keeps the (B, T, V) fp32 logits on the device,
where they are 23 GB at the WikiText-103 recipe's size, and returns their
argmax ids in their place (``decoder_output["ids"]``, (B, T)), with the
loss: eval reads the loss, infer the ids, and nothing else crosses to the
host. :meth:`finalize_inference` writes one line of ids per sequence (the
JAX model writes each batch's (B, T) array as one numpy repr).

Not ported yet: ``generate``, which needs the WikiText vocabulary of
``data/lm``, and classification transfer (``lm_mode: False``, a data layer
with ``num_classes``), refused by the encoder.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..utils.logging import deco_print

from .encoder_decoder import EncoderDecoderModel


class LSTMLM(EncoderDecoderModel):

    def _create_encoder(self):
        dl_params = self.get_data_layer().params
        if "num_classes" in dl_params:
            raise NotImplementedError(
                "a classification data layer (lm_mode: False) is not "
                "ported yet: it comes with the LM transfer slice "
                "(ROADMAP.md)")
        self._params.setdefault("encoder_params", {})
        ep = self._params["encoder_params"]
        ep.setdefault("vocab_size", dl_params["vocab_size"])
        ep.setdefault("end_token", dl_params.get("end_token", 1))
        ep.setdefault("batch_size", dl_params["batch_size"])
        return super()._create_encoder()

    def _create_loss(self):
        loss_cls = self._params.get("loss")
        if loss_cls is not None:
            accepts = {**loss_cls.get_required_params(),
                       **loss_cls.get_optional_params()}
            self._params.setdefault("loss_params", {})
            lp = self._params["loss_params"]
            dl_params = self.get_data_layer().params
            if "tgt_vocab_size" in accepts:
                lp.setdefault("tgt_vocab_size", dl_params["vocab_size"])
            if "batch_size" in accepts:
                lp.setdefault("batch_size", dl_params["batch_size"])
            # the targets are already next-token aligned
            if "offset_target_by_one" in accepts:
                lp.setdefault("offset_target_by_one", False)
            if "average_across_timestep" in accepts:
                lp.setdefault("average_across_timestep", True)
        return super()._create_loss()

    def eval_step(self, state, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The loss (with targets and a loss) and the argmax ids (B, T)
        of the logits, which stay on the device."""
        result = super().eval_step(state, batch)
        dec = result["outputs"]["decoder_output"]
        with torch.no_grad():
            ids = dec["logits"].argmax(-1)
        result["outputs"] = {"decoder_output": {
            "ids": ids, "src_length": dec["src_length"]}}
        return result

    def evaluate(self, input_values, output_values):
        """(loss x tokens, tokens) over the valid rows."""
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        tokens = int(np.sum(np.asarray(
            input_values["target_tensors"][1])[:valid]))
        loss = float(output_values.get("loss", 0.0))
        return (loss * tokens, tokens)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        total_nll = sum(r[0] for r in results_per_batch)
        total_tokens = sum(r[1] for r in results_per_batch)
        avg = total_nll / max(total_tokens, 1)
        ppl = math.exp(min(avg, 30.0))
        deco_print("Validation perplexity: {:.2f}".format(ppl), offset=4)
        return {"Eval perplexity": ppl, "eval_loss": avg}

    def infer(self, input_values, output_values):
        """The argmax ids of the valid rows, one (T,) array each."""
        ids = np.asarray(output_values["outputs"]["decoder_output"]["ids"])
        valid = int(input_values.get("batch_valid", ids.shape[0]))
        return list(ids[:valid])

    def finalize_inference(self, results_per_batch, output_file):
        with open(output_file, "w") as f:
            for batch in results_per_batch:
                for row in batch:
                    f.write(" ".join(str(int(i)) for i in row) + "\n")
        deco_print("Predictions saved to {}".format(output_file))

    def generate(self, *args, **kwargs):
        raise NotImplementedError("LSTMLM.generate is not ported yet: it "
                                  "needs the WikiText vocabulary of data/lm "
                                  "(ROADMAP.md)")

    def get_num_objects_per_step(self, batch):
        """Tokens in the batch."""
        return int(np.sum(np.asarray(batch["source_tensors"][1])))
