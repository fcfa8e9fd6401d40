"""WaveNet loss (port of ``openseq2seq_tpu/losses/wavenet_loss.py``): the
softmax cross-entropy of the fp32 logits (B, T, Q) against the mu-law
labels (B, T), averaged over the samples within each audio length."""
from __future__ import annotations

import torch

from .loss import Loss


class WavenetLoss(Loss):

    def compute_loss(self, input_dict):
        dec = input_dict["decoder_output"]
        logits = dec["logits"].float()
        labels = dec["labels"].long()
        lengths = dec.get("audio_len")
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, labels[..., None])[..., 0]
        if lengths is None:
            mask = torch.ones_like(nll)
        else:
            mask = (torch.arange(labels.shape[1], device=labels.device)[
                None, :] < lengths[:, None]).float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
