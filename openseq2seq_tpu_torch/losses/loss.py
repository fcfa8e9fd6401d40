"""Loss abstract class (port of ``openseq2seq_tpu/losses/loss.py``).

A loss is a function of decoder output and target tensors, with no
parameters; ``compute_loss`` returns an fp32 scalar.
"""
from __future__ import annotations

import abc
from typing import Any, Dict

from ..utils.params import check_params


class Loss(abc.ABC):

    @staticmethod
    def get_required_params():
        return {}

    @staticmethod
    def get_optional_params():
        return {"dtype": None}

    def __init__(self, params: Dict[str, Any], model, name: str = "loss"):
        check_params(params, self.get_required_params(),
                     self.get_optional_params())
        self._params = dict(params)
        self._model = model
        self._name = name

    @property
    def params(self):
        return self._params

    @abc.abstractmethod
    def compute_loss(self, input_dict: Dict[str, Any]):
        """input_dict has "decoder_output" (dict) and "target_tensors"
        ([y, y_len]); returns an fp32 scalar loss."""
