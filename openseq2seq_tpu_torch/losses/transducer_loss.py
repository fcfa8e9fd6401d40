"""Transducer (RNN-T) loss component (port of
``openseq2seq_tpu/losses/transducer_loss.py``): fp32 recursion whatever
the compute dtype, blank as the last class. It takes the decoder's
(B, T, U+1, V) ``logits`` to :func:`..ops.transducer.transducer_loss`, or,
with ``decoder_params: {"fused_loss": True}``, its ``joint_fused``
activations to :func:`..ops.transducer.transducer_loss_fused`, which never
holds the lattice.
"""
from __future__ import annotations

from .loss import Loss
from ..ops.transducer import transducer_loss, transducer_loss_fused


class TransducerLoss(Loss):

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "fused_block_size": int,   # anti-diagonals per fused-loss
                                       # block (default 8)
            "fastemit_lambda": float,  # FastEmit (arXiv:2010.11148)
                                       # emission-gradient scale; 0 = off
        })

    def compute_loss(self, input_dict):
        """input_dict:
          decoder_output: {"logits": (B, T, U+1, V), "src_length": (B,)},
            or {"joint_fused": {"enc_j", "pred_j", "joint_b", "out_w",
            "out_b"}, "src_length"}
          target_tensors: [labels (B, U), label_lengths (B,)]
        """
        dec = input_dict["decoder_output"]
        logit_lengths = dec["src_length"]
        labels, label_lengths = input_dict["target_tensors"]
        lam = float(self._params.get("fastemit_lambda", 0.0))
        fused = dec.get("joint_fused")
        if fused is not None:
            return transducer_loss_fused(
                fused["enc_j"], fused["pred_j"], fused["joint_b"],
                fused["out_w"], fused["out_b"], logit_lengths, labels,
                label_lengths, blank_id=-1, average_across_batch=True,
                block_size=self._params.get("fused_block_size", 8),
                fastemit_lambda=lam)
        return transducer_loss(dec["logits"], logit_lengths, labels,
                               label_lengths, blank_id=-1,
                               average_across_batch=True,
                               fastemit_lambda=lam)
