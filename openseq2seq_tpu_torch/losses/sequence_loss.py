"""Sequence loss for the transformer (port of
``PaddedCrossEntropyLossWithSmoothing`` in
``openseq2seq_tpu/losses/sequence_loss.py:111-146``): label smoothing
with confidence 1 - s on the gold class and s / (V - 1) on each other
class, the exact normalizing constant (the least possible loss)
subtracted, averaged over non-pad (id != 0) positions, in fp32. The
other sequence losses of that module are not ported yet.
"""
from __future__ import annotations

import math

import torch

from .loss import Loss


class PaddedCrossEntropyLossWithSmoothing(Loss):

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "batch_size": int,
            "tgt_vocab_size": int,
            "label_smoothing": float,
            "pad_embeddings_2_eight": bool,
        })

    def __init__(self, params, model, name="padded_cross_entropy"):
        super().__init__(params, model, name)
        self._smoothing = self._params.get("label_smoothing", 0.0)

    def compute_loss(self, input_dict):
        labels = input_dict["target_tensors"][0].long()
        logits = input_dict["decoder_output"]["logits"].float()
        logits = logits[:, :labels.shape[1], :]
        V = logits.shape[-1]
        confidence = 1.0 - self._smoothing
        low = self._smoothing / (V - 1) if V > 1 else 0.0
        logp = torch.log_softmax(logits, dim=-1)
        gold = torch.gather(logp, -1, labels[..., None])[..., 0]
        # sum_v soft_v logp_v with soft = low everywhere, confidence at gold
        xent = -(low * logp.sum(-1) + (confidence - low) * gold)
        if self._smoothing > 0 and V > 1:
            xent = xent + (confidence * math.log(confidence) +
                           (V - 1) * low * math.log(low + 1e-20))
        mask = (labels != 0).float()
        return (xent * mask).sum() / mask.sum().clamp(min=1.0)
