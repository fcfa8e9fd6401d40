"""The pieces that ConvS2S's encoder and decoder share
(``encoders/convs2s_encoder.py``, ``decoders/convs2s_decoder.py``; the
JAX package keeps them in its encoder module): the GLU conv block, the
sqrt(0.5) residual scale and the learned embedding tables."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .dropout import dropout
from .transformer.common import Dense, weak_scalar

SCALE = math.sqrt(0.5)


def scaled(x: torch.Tensor) -> torch.Tensor:
    """x sqrt(0.5), the factor rounded to x's type as JAX rounds it."""
    return x * weak_scalar(SCALE, x.dtype)


def glu_block(x: torch.Tensor, conv: nn.Module, res_proj: Optional[Dense],
              keep_prob: float, train: bool, generator: torch.Generator,
              dropout_bits: int) -> torch.Tensor:
    """Dropout, conv, GLU, plus the (projected) input, times sqrt(0.5)."""
    residual = x if res_proj is None else res_proj(x)
    if train:
        x = dropout(x, keep_prob, generator, dropout_bits)
    a, b = torch.chunk(conv(x), 2, dim=-1)
    return scaled(a * torch.sigmoid(b) + residual)


def learned_embeddings(vocab_size: int, max_length: int, width: int,
                       generator: torch.Generator):
    """The ``embedding`` and ``pos_embedding`` leaves, N(0, 0.1^2)."""
    tables = []
    for rows in (vocab_size, max_length):
        t = nn.Parameter(torch.empty(rows, width))
        with torch.no_grad():
            t.normal_(0.0, 0.1, generator=generator)
        tables.append(t)
    return tables
