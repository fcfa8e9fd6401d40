"""Tacotron loss (port of ``openseq2seq_tpu/losses/text2speech_loss.py``):
the L2 (or, with ``l1_norm``, L1) error of the decoder's and the
postnet's spectrograms plus the stop token's sigmoid cross-entropy in its
stable form, each masked by the spectrogram lengths (``use_mask``) and
averaged over the frames that count, all in fp32.

The JAX loss's ``scale`` key has no effect there and is refused here.
"""
from __future__ import annotations

import torch

from .loss import Loss


class Text2SpeechLoss(Loss):

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "use_mask": bool,
            "l1_norm": bool,
            "stop_token_weight": float,
        })

    def __init__(self, params, model, name="text2speech_loss"):
        super().__init__(params, model, name)
        self._use_mask = self._params.get("use_mask", True)
        self._l1 = self._params.get("l1_norm", False)
        self._stop_w = self._params.get("stop_token_weight", 1.0)

    def _spec_loss(self, pred, target, mask):
        diff = pred.float() - target.float()
        per = diff.abs() if self._l1 else diff.square()
        per = per * mask[:, :, None]
        return per.sum() / torch.clamp(mask.sum(), min=1.0) / pred.shape[-1]

    def compute_loss(self, input_dict):
        dec = input_dict["decoder_output"]
        spec, stop_target, spec_len = input_dict["target_tensors"][:3]
        T = dec["decoder_spec"].shape[1]
        spec = spec[:, :T]
        stop_target = stop_target[:, :T].float()
        if self._use_mask:
            mask = (torch.arange(T, device=spec.device)[None, :] <
                    spec_len[:, None]).float()
        else:
            mask = torch.ones((spec.shape[0], T), device=spec.device)
        dec_loss = self._spec_loss(dec["decoder_spec"], spec, mask)
        post_loss = self._spec_loss(dec["post_net_spec"], spec, mask)
        logits = dec["stop_token_logits"].float()
        stop_ce = torch.clamp(logits, min=0) - logits * stop_target + \
            torch.log1p(torch.exp(-logits.abs()))
        stop_loss = (stop_ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return dec_loss + post_loss + self._stop_w * stop_loss
