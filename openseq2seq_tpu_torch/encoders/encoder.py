"""Encoder abstract class (port of ``openseq2seq_tpu/encoders/encoder.py``).

A concrete encoder validates its params against the same schema as the
JAX package's and implements :meth:`make_module`, which returns an
``nn.Module`` whose ``forward(input_dict, train)`` maps
``{"source_tensors": [x, x_len]}`` to ``{"outputs", "src_length"}``, with
x and outputs (B, T, C). Mixed precision follows the model's policy:
params in fp32, compute in :attr:`compute_dtype`.
"""
from __future__ import annotations

import abc
from typing import Any, Dict

import torch

from ..utils.params import check_params


class Encoder(abc.ABC):

    @staticmethod
    def get_required_params():
        return {}

    @staticmethod
    def get_optional_params():
        return {
            "initializer": None,          # name or (weight, generator) fn
            "initializer_params": dict,
            "regularizer": None,          # read by training
            "regularizer_params": dict,
            "dtype": None,                # overrides model compute dtype
        }

    def __init__(self, params: Dict[str, Any], model,
                 name: str = "encoder", mode: str = "train"):
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

    @property
    def compute_dtype(self) -> torch.dtype:
        if self._params.get("dtype") is not None:
            from ..optimizers.mixed_precision import get_mp_policy
            return get_mp_policy(self._params["dtype"]).compute_dtype
        if self._model is not None:
            return self._model.mp_policy.compute_dtype
        return torch.float32

    @abc.abstractmethod
    def make_module(self, in_features: int,
                    generator: torch.Generator) -> torch.nn.Module:
        """Build the encoder's module for inputs of ``in_features``
        channels, its weights drawn from ``generator``. The module has
        an ``out_features`` attribute."""
