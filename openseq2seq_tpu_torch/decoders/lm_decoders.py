"""Pass-through decoder for models whose encoder already emits logits
(port of ``openseq2seq_tpu/decoders/lm_decoders.py``): the language
model."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .decoder import Decoder


class FakeDecoderModule(nn.Module):

    def __init__(self, in_features: int):
        super().__init__()
        self.out_features = in_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """Everything the encoder produced, as it is."""
        return dict(input_dict["encoder_output"])


class FakeDecoder(Decoder):

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FakeDecoderModule:
        return FakeDecoderModule(in_features)
