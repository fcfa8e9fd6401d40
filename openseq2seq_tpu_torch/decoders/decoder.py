"""Decoder abstract class (port of ``openseq2seq_tpu/decoders/decoder.py``),
the mirror of :mod:`..encoders.encoder`. A concrete decoder's module maps
``{"encoder_output": {...}, "target_tensors": [y, y_len]}`` to
``{"logits": ..., "outputs": [...]}``, where "outputs" are
inference-ready (decoded ids, etc.).
"""
from __future__ import annotations

import abc
from typing import Any, Dict

import torch

from ..utils.params import check_params


class Decoder(abc.ABC):

    @staticmethod
    def get_required_params():
        return {}

    @staticmethod
    def get_optional_params():
        return {
            "initializer": None,
            "initializer_params": dict,
            "regularizer": None,
            "regularizer_params": dict,
            "dtype": None,
        }

    def __init__(self, params: Dict[str, Any], model,
                 name: str = "decoder", mode: str = "train"):
        check_params(params, self.get_required_params(),
                     self.get_optional_params())
        self._params = dict(params)
        self._model = model
        self._name = name
        self._mode = mode

    @property
    def params(self):
        return self._params

    @property
    def mode(self):
        return self._mode

    @property
    def name(self):
        return self._name

    @abc.abstractmethod
    def make_module(self, in_features: int,
                    generator: torch.Generator) -> torch.nn.Module:
        """Build the decoder's module over encoder outputs of
        ``in_features`` channels, its weights drawn from ``generator``."""
