"""Position-wise feed-forward network (port of
``openseq2seq_tpu/parts/transformer/ffn.py``): ``filter`` (d -> f), relu,
``output`` (f -> d), in the compute dtype. Its relu dropout (and the
fused Pallas dropout behind it) runs only in training, which is not
ported yet; the mixture-of-experts variant is refused by the encoder.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .common import Dense


class FeedForwardNetwork(nn.Module):

    def __init__(self, hidden_size: int, filter_size: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.filter = Dense(hidden_size, filter_size, dtype, generator)
        self.output = Dense(filter_size, hidden_size, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(torch.relu(self.filter(x)))
