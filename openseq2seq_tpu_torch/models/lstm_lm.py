"""LSTM language model task (port of ``openseq2seq_tpu/models/lstm_lm.py``):
perplexity on eval, argmax ids on infer, tokens as the objects of a step,
greedy or sampled generation; with a classification data layer (one that
sets ``num_classes``: ``data/lm`` IMDB, SST) the transfer task, accuracy
on eval and the argmax class on infer.

The encoder (``encoders/lm_encoders.py``, or Transformer-XL's) emits the
logits, or in training the sampled-softmax bundle, and ``FakeDecoder``
passes them through; the loss defaults follow the JAX model (the data
layer's vocabulary and batch size, targets already next-token aligned,
averaged over time).

:meth:`LSTMLM.eval_step` keeps the logits on the device, where in LM mode
they are (B, T, V) fp32, 23 GB at the WikiText-103 recipe's size, and
returns their argmax ids in their place (``decoder_output["ids"]``), with
the loss: eval reads the loss (LM) or the ids (accuracy), infer the ids,
and nothing else crosses to the host. :meth:`finalize_inference` writes
one line a sequence: its ids in LM mode (the JAX model writes each
batch's (B, T) array as one numpy repr), its class in classification.

:meth:`generate` continues a prompt over a fixed-size buffer, as the JAX
model does, the vocabulary taken from the data layer's ``Corpus``: the
argmax at temperature 0, else a draw from the softmax of logits /
temperature by a ``torch.Generator`` seeded with ``rng_seed`` (JAX's
threefry bits cannot be drawn here, so sampled tokens agree in law, not
bit for bit).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..utils.logging import deco_print

from .encoder_decoder import EncoderDecoderModel
from .model import to_device_batch


class LSTMLM(EncoderDecoderModel):

    def __init__(self, params, mode="train", device="cuda", num_workers=1,
                 worker_id=0):
        super().__init__(params, mode, device, num_workers, worker_id)
        self._lm_mode = self._params.get("encoder_params", {}).get(
            "lm_mode", True)

    def _create_encoder(self):
        dl_params = self.get_data_layer().params
        self._params.setdefault("encoder_params", {})
        ep = self._params["encoder_params"]
        ep.setdefault("vocab_size", dl_params["vocab_size"])
        ep.setdefault("end_token", dl_params.get("end_token", 1))
        ep.setdefault("batch_size", dl_params["batch_size"])
        if "num_classes" in dl_params:
            ep.setdefault("lm_mode", False)
            ep.setdefault("num_classes", dl_params["num_classes"])
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
        """The loss (with targets and a loss) and the argmax ids of the
        logits, (B, T) or (B,), which stay on the device."""
        result = super().eval_step(state, batch)
        dec = result["outputs"]["decoder_output"]
        with torch.no_grad():
            ids = dec["logits"].argmax(-1)
        result["outputs"] = {"decoder_output": {
            "ids": ids, "src_length": dec["src_length"]}}
        return result

    def evaluate(self, input_values, output_values):
        """LM: (loss x tokens, tokens) over the valid rows;
        classification: (correct, valid rows)."""
        valid = int(input_values.get(
            "batch_valid", input_values["source_tensors"][0].shape[0]))
        if not self._lm_mode:
            ids = np.asarray(
                output_values["outputs"]["decoder_output"]["ids"])[:valid]
            labels = np.asarray(input_values["target_tensors"][0])[:valid]
            return (int(np.sum(ids == labels)), valid)
        tokens = int(np.sum(np.asarray(
            input_values["target_tensors"][1])[:valid]))
        loss = float(output_values.get("loss", 0.0))
        return (loss * tokens, tokens)

    def finalize_evaluation(self, results_per_batch, training_step=None):
        if not self._lm_mode:
            correct = sum(r[0] for r in results_per_batch)
            total = sum(r[1] for r in results_per_batch)
            acc = correct / max(total, 1)
            deco_print("Validation accuracy: {:.4f}".format(acc), offset=4)
            return {"Eval accuracy": acc, "eval_loss": 1.0 - acc}
        total_nll = sum(r[0] for r in results_per_batch)
        total_tokens = sum(r[1] for r in results_per_batch)
        avg = total_nll / max(total_tokens, 1)
        ppl = math.exp(min(avg, 30.0))
        deco_print("Validation perplexity: {:.2f}".format(ppl), offset=4)
        return {"Eval perplexity": ppl, "eval_loss": avg}

    def infer(self, input_values, output_values):
        """The argmax ids of the valid rows: one (T,) array each, or in
        classification one class each."""
        ids = np.asarray(output_values["outputs"]["decoder_output"]["ids"])
        valid = int(input_values.get("batch_valid", ids.shape[0]))
        return list(ids[:valid])

    def finalize_inference(self, results_per_batch, output_file):
        with open(output_file, "w") as f:
            for batch in results_per_batch:
                for row in batch:
                    f.write(" ".join(str(int(i)) for i in np.ravel(row)) +
                            "\n")
        deco_print("Predictions saved to {}".format(output_file))

    def generate(self, state, seed_tokens=None, num_tokens: int = 50,
                 temperature: float = 0.0, rng_seed: int = 0) -> str:
        """The prompt ``seed_tokens`` (default the encoder's
        ``seed_tokens``, else "the") continued by ``num_tokens`` words:
        the LM re-run over the growing prefix in a buffer of a fixed
        length, a multiple of 8, and the next word taken from the logits
        at the prefix's last position."""
        corp = getattr(self.get_data_layer(), "corp", None)
        if corp is None:
            raise ValueError("generate needs a data layer with a Corpus "
                             "(data/lm WKTDataLayer) for its vocabulary")
        w2i, i2w = corp.word2idx, corp.idx2word
        seed_tokens = seed_tokens or \
            str(self._params.get("encoder_params", {})
                .get("seed_tokens", "the")).split()
        ids = [w2i.get(t, w2i.get("<unk>", 0)) for t in seed_tokens]
        max_len = ((len(ids) + num_tokens + 7) // 8) * 8
        buf = np.zeros((1, max_len), np.int32)
        buf[0, :len(ids)] = ids
        batch = {"source_tensors": [buf, np.full((1,), max_len, np.int32)]}
        generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        pos = len(ids) - 1
        with torch.no_grad():
            for _ in range(num_tokens):
                out = state.module(to_device_batch(batch, self.device),
                                   train=False)
                logits = out["decoder_output"]["logits"][0, pos]
                if temperature > 0:
                    probs = torch.softmax(logits / temperature, dim=-1)
                    nxt = int(torch.multinomial(probs, 1,
                                                generator=generator))
                else:
                    nxt = int(torch.argmax(logits))
                pos += 1
                if pos >= max_len:
                    break
                buf[0, pos] = nxt
        return " ".join(i2w.get(int(i), "<unk>") for i in buf[0, :pos + 1])

    def get_num_objects_per_step(self, batch):
        """Tokens in the batch."""
        return int(np.sum(np.asarray(batch["source_tensors"][1])))
