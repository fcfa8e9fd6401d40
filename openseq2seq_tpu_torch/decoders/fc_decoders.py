"""Fully-connected decoders (port of
``openseq2seq_tpu/decoders/fc_decoders.py``).

  * :class:`FullyConnectedDecoder` — one dense layer for classification
    over the flattened encoder outputs; :class:`FullyConnectedSCDecoder`,
    the speech-commands variant, first averages a (B, T, C) output over
    its valid frames;
  * :class:`FullyConnectedTimeDecoder` — per-frame dense projection to
    vocabulary logits, batch-major (B, T, V).
  * :class:`FullyConnectedCTCDecoder` — adds greedy CTC decoding outside
    training. Beam search (``on_device_beam_width > 1``) and the
    host-side language-model decode (``use_language_model``) are not
    ported yet and raise.

The dense layer computes in the model's compute dtype from fp32 params;
logits are cast to fp32 before the loss and the decode, as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .decoder import Decoder
from ..ops.ctc import ctc_greedy_decode
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import dense


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W + b in ``dtype``, rounded as flax
    rounds it (``parts/transformer/common.dense``), W stored (out, in);
    no b with ``use_bias`` False."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, kernel_init,
                 generator: torch.Generator, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias \
            else None
        kernel_init(self.weight, generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.to(self.dtype), self.weight.to(self.dtype),
                     None if self.bias is None
                     else self.bias.to(self.dtype))


class FCTimeDecoderModule(nn.Module):

    def __init__(self, fully_connected: Dense, greedy_ctc: bool):
        super().__init__()
        self.fully_connected = fully_connected
        self.greedy_ctc = greedy_ctc

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` is unused: the layer has no dropout."""
        x = input_dict["encoder_output"]["outputs"]
        src_length = input_dict["encoder_output"]["src_length"]
        # logits feed fp32 losses and decoders
        logits = self.fully_connected(x).float()
        out: Dict[str, Any] = {"logits": logits, "src_length": src_length}
        if self.greedy_ctc and not train:
            out["outputs"] = list(ctc_greedy_decode(logits, src_length))
        return out


class FullyConnectedTimeDecoder(Decoder):

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "tgt_vocab_size": int,
        })

    def _dense(self, in_features: int, generator: torch.Generator) -> Dense:
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        kinit = resolve_initializer(self._params.get("initializer"),
                                    self._params.get("initializer_params"))
        return Dense(in_features, self._params["tgt_vocab_size"], dtype,
                     kinit, generator)

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCTimeDecoderModule:
        return FCTimeDecoderModule(self._dense(in_features, generator),
                                   greedy_ctc=False)


class FullyConnectedCTCDecoder(FullyConnectedTimeDecoder):
    """FC time decoder plus greedy CTC decoding outside training."""

    @staticmethod
    def get_required_params():
        return dict(FullyConnectedTimeDecoder.get_required_params(), **{
            "use_language_model": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(FullyConnectedTimeDecoder.get_optional_params(), **{
            "on_device_beam_width": int,
        })

    def __init__(self, params, model, name="fully_connected_ctc_decoder",
                 mode="train"):
        super().__init__(params, model, name, mode)
        if self._params["use_language_model"]:
            raise NotImplementedError(
                "language-model beam decoding is not ported yet")
        if self._params.get("on_device_beam_width", 0) > 1:
            raise NotImplementedError(
                "on-device CTC beam search is not ported yet")

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCTimeDecoderModule:
        return FCTimeDecoderModule(self._dense(in_features, generator),
                                   greedy_ctc=True)


class FCDecoderModule(nn.Module):
    """One dense layer, ``fully_connected``, over the encoder's outputs
    flattened past the batch axis; with ``masked_mean`` a (B, T, C) output
    with ``src_length`` is first averaged over its valid frames. Logits in
    the compute dtype (``fp32_logits`` False, as ``FullyConnectedDecoder``)
    or fp32, and their argmax as ``outputs``."""

    def __init__(self, fully_connected: Dense, masked_mean: bool,
                 fp32_logits: bool):
        super().__init__()
        self.fully_connected = fully_connected
        self.masked_mean, self.fp32_logits = masked_mean, fp32_logits

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` is unused: the layer has no dropout."""
        x = input_dict["encoder_output"]["outputs"]
        lengths = input_dict["encoder_output"].get("src_length")
        if self.masked_mean and x.dim() == 3 and lengths is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :] <
                    lengths[:, None]).to(x.dtype)
            x = (x * mask[:, :, None]).sum(1) / \
                mask.sum(1).clamp_min(1.0)[:, None]
        elif x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        logits = self.fully_connected(x)
        if self.fp32_logits:
            logits = logits.float()
        return {"logits": logits, "outputs": [logits.argmax(-1)]}


class FullyConnectedDecoder(Decoder):
    """One dense layer for classification
    (``openseq2seq_tpu/decoders/fc_decoders.py:31-57``): the encoder's
    outputs flattened to (B, -1), logits in the compute dtype."""

    masked_mean, fp32_logits = False, False

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "output_dim": int,
        })

    def input_width(self, out_shape, has_lengths: bool) -> int:
        """The dense layer's input width for encoder outputs of
        ``out_shape`` an example (the batch axis left out)."""
        if self.masked_mean and len(out_shape) == 2 and has_lengths:
            return int(out_shape[-1])
        width = 1
        for n in out_shape:
            width *= int(n)
        return width

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCDecoderModule:
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        kinit = resolve_initializer(self._params.get("initializer"),
                                    self._params.get("initializer_params"))
        return FCDecoderModule(
            Dense(in_features, self._params["output_dim"], dtype, kinit,
                  generator), self.masked_mean, self.fp32_logits)


class FullyConnectedSCDecoder(FullyConnectedDecoder):
    """Speech-commands decoder (``fc_decoders.py:211-249``): a (B, T, C)
    output with lengths is averaged over its valid frames, any other is
    flattened; fp32 logits."""

    masked_mean, fp32_logits = True, True
