"""Softmax cross entropy for classification (port of
``openseq2seq_tpu/losses/cross_entropy_loss.py``): fp32 logits (B, C)
against integer labels (B,) or one-hot / soft labels (B, C), averaged
over the batch."""
from __future__ import annotations

import torch

from .loss import Loss


class CrossEntropyLoss(Loss):

    def compute_loss(self, input_dict):
        logits = input_dict["decoder_output"]["logits"].float()
        labels = input_dict["target_tensors"][0]
        logp = torch.log_softmax(logits, dim=-1)
        if labels.dim() == logits.dim():            # one-hot
            losses = -(labels.float() * logp).sum(-1)
        else:
            losses = -logp.gather(-1, labels.long()[:, None])[:, 0]
        return losses.mean()
