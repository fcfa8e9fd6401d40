"""CTC loss component (port of ``openseq2seq_tpu/losses/ctc_loss.py``).

fp32 whatever the compute dtype, infeasible rows zeroed under
``mask_nan``, blank as the last class. ``use_pallas`` (the JAX package's
switch to its fused TPU kernel) selects the hand-written CUDA kernel
(``ops/ctc_cuda.py``), which runs for CUDA tensors; CPU tensors take its
plain version.
"""
from __future__ import annotations

from .loss import Loss
from ..ops.ctc import ctc_loss
from ..ops.ctc_cuda import ctc_loss_cuda


class CTCLoss(Loss):

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "mask_nan": bool,
            "use_pallas": bool,   # the recursion on the CTC kernel
        })

    def __init__(self, params, model, name="ctc_loss"):
        super().__init__(params, model, name)
        self._mask_nan = self._params.get("mask_nan", True)
        self._loss_fn = ctc_loss_cuda if self._params.get("use_pallas") \
            else ctc_loss

    def compute_loss(self, input_dict):
        """input_dict:
          decoder_output: {"logits": (B, T, V), "src_length": (B,)}
          target_tensors: [labels (B, L), label_lengths (B,)]
        """
        dec = input_dict["decoder_output"]
        labels, label_lengths = input_dict["target_tensors"]
        return self._loss_fn(dec["logits"], dec["src_length"], labels,
                             label_lengths, blank_id=-1,
                             ignore_longer_outputs_than_inputs=self._mask_nan,
                             average_across_batch=True)
