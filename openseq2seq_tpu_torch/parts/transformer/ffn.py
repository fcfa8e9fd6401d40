"""Position-wise feed-forward network (port of
``openseq2seq_tpu/parts/transformer/ffn.py``): ``filter`` (d -> f), relu,
``output`` (f -> d), in the compute dtype. In training the relu output
takes dropout at ``relu_dropout``, routed as the JAX package routes it:
with ``fused_dropout`` (the model key ``fused_residual_dropout``) and a
filter width that is a multiple of 128, kernel B2's
``ops/fused_dropout.fused_dropout`` on relu(filter(x)) with a seed drawn
from the step's generator; otherwise ``parts/dropout.relu_dropout``. On a
CUDA tensor the fused route launches the kernel or raises. The
mixture-of-experts variant is refused by the encoder.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...ops import fused_dropout as fd
from ..dropout import relu_dropout
from .common import Dense


class FeedForwardNetwork(nn.Module):

    def __init__(self, hidden_size: int, filter_size: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 relu_dropout: float = 0.0, dropout_bits: int = 32,
                 fused_dropout: bool = False):
        super().__init__()
        self.filter = Dense(hidden_size, filter_size, dtype, generator)
        self.output = Dense(filter_size, hidden_size, dtype, generator)
        self.relu_dropout = relu_dropout
        self.dropout_bits = dropout_bits
        self.fused_dropout = fused_dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.filter(x)
        if not train or self.relu_dropout <= 0.0:
            h = torch.relu(h)
        elif self.fused_dropout and fd.supported(h.shape):
            h = fd.fused_dropout(torch.relu(h), self.relu_dropout,
                                 fd.draw_seed(generator, h.device))
        else:
            h = relu_dropout(h, self.relu_dropout, generator,
                             self.dropout_bits)
        return self.output(h)
