"""Encoder -> decoder -> loss composition (port of
``openseq2seq_tpu/models/encoder_decoder.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .model import Model


class ForwardPass(nn.Module):
    """``enc`` then ``dec``, named as the flax module's children."""

    def __init__(self, enc: nn.Module, dec: nn.Module):
        super().__init__()
        self.enc = enc
        self.dec = dec

    def forward(self, batch: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` draws the dropout of both in training."""
        encoder_output = self.enc(batch, train, generator)
        dec_input = dict(batch)
        dec_input["encoder_output"] = encoder_output
        decoder_output = self.dec(dec_input, train, generator)
        return {"encoder_output": encoder_output,
                "decoder_output": decoder_output}


class EncoderDecoderModel(Model):
    """Model composed of an encoder, a decoder and a loss component, each
    built from a config class and its params dict."""

    @staticmethod
    def get_required_params():
        return dict(Model.get_required_params(), **{
            "encoder": None,
            "decoder": None,
        })

    @staticmethod
    def get_optional_params():
        return dict(Model.get_optional_params(), **{
            "encoder_params": dict,
            "decoder_params": dict,
            "loss": None,
            "loss_params": dict,
        })

    def __init__(self, params, mode="train", device="cuda",
                 num_workers=1, worker_id=0):
        super().__init__(params, mode, device, num_workers, worker_id)
        self._encoder = self._create_encoder()
        self._decoder = self._create_decoder()
        self._loss_computator = (self._create_loss()
                                 if mode in ("train", "eval") else None)

    def _inherit_initializer(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """A component without its own initializer takes the model's."""
        if "initializer" not in params and \
                self._params.get("initializer") is not None:
            params["initializer"] = self._params["initializer"]
            if self._params.get("initializer_params") is not None:
                params.setdefault("initializer_params",
                                  self._params["initializer_params"])
        return params

    def _create_encoder(self):
        params = self._inherit_initializer(
            dict(self._params.get("encoder_params", {})))
        return self._params["encoder"](params=params, model=self,
                                       mode=self._mode)

    def _create_decoder(self):
        params = self._inherit_initializer(
            dict(self._params.get("decoder_params", {})))
        return self._params["decoder"](params=params, model=self,
                                       mode=self._mode)

    def _create_loss(self):
        if self._params.get("loss") is None:
            return None
        params = dict(self._params.get("loss_params", {}))
        return self._params["loss"](params=params, model=self)

    @property
    def has_loss(self) -> bool:
        return self._loss_computator is not None

    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> ForwardPass:
        in_features = example_batch["source_tensors"][0].shape[-1]
        enc = self._encoder.make_module(in_features, generator)
        dec = self._decoder.make_module(enc.out_features, generator)
        return ForwardPass(enc, dec)

    def compute_loss(self, outputs, batch):
        if self._loss_computator is None:
            raise ValueError("No loss was configured (infer-only model?)")
        return self._loss_computator.compute_loss({
            "decoder_output": outputs["decoder_output"],
            "target_tensors": batch.get("target_tensors"),
        })
