"""Joint CTC and cross-entropy loss (port of
``openseq2seq_tpu/losses/jca_loss.py``; reference
`open_seq2seq/losses/jca_loss.py:15-120`): ``lambda * ctc + (1 - lambda)
* ce``, both fp32.

  * CTC on the CTC head's logits against the targets without their start
    and end symbols (``labels[:, 1:]``, lengths ``label_lens - 2``), the
    mean over the batch with infeasible rows zeroed, blank the last class.
    It runs through ``ops/ctc_cuda.ctc_loss_cuda``: on CUDA tensors
    kernel B1a with its lattice and, in the backward, B1b; on CPU tensors
    their plain version;
  * cross entropy of the attention head's logits against ``labels[:,
    1:]``, averaged over the ``label_lens - 1`` valid tokens.

``ctc_loss_params`` and ``seq_loss_params`` are accepted with no effect,
as in the JAX package, which reads neither (C28).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .loss import Loss
from ..ops.ctc_cuda import ctc_loss_cuda


class MultiTaskCTCEntropyLoss(Loss):

    @staticmethod
    def get_required_params():
        return dict(Loss.get_required_params(), **{
            "ctc_loss_params": dict,
            "seq_loss_params": dict,
            "lambda_value": float,
            "tgt_vocab_size": int,
            "batch_size": int,
        })

    def __init__(self, params, model, name="jca_loss"):
        super().__init__(params, model, name)
        self.lam = self._params["lambda_value"]

    def compute_loss(self, input_dict):
        dec = input_dict["decoder_output"]
        labels, label_lens = input_dict["target_tensors"][:2]

        ctc_out = dec["ctc_outputs"]
        ctc = ctc_loss_cuda(ctc_out["logits"], ctc_out["src_length"],
                            labels[:, 1:].contiguous(),
                            torch.clamp(label_lens - 2, min=0),
                            average_across_batch=True)

        logits = dec["seq_outputs"]["logits"].float()
        y = labels[:, 1:]
        logits = logits[:, :y.shape[1], :]
        nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                            y.long()[..., None])[..., 0]
        mask = (torch.arange(y.shape[1], device=y.device)[None, :] <
                (label_lens - 1)[:, None]).float()
        ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        return self.lam * ctc + (1.0 - self.lam) * ce
