"""Transformer building blocks (port of
``openseq2seq_tpu/parts/transformer/common.py``).

  * :func:`get_position_encoding`: sinusoids as ``[sin | cos]`` halves
    (not interleaved), fp32, built with numpy as the JAX package does;
    :func:`rel_pos_embedding`, the Conformer's relative-distance table,
    likewise;
  * :func:`get_padding_bias` (pad id 0) and
    :func:`get_decoder_self_attention_bias`: additive fp32 biases of
    ``NEG_INF`` = -1e9;
  * :class:`SharedEmbedding`: the one (V, d) table, V padded to a
    multiple of eight under ``pad_vocab_to_eight``, that embeds source
    and target ids (scaled by sqrt(d), pad id 0 zeroed) and, through
    :func:`project_logits`, projects decoder states to fp32 logits;
  * :class:`TransformerNorm`: the layer-norm variant (eps 1e-6, statistics
    and normalization in fp32, output in the compute dtype). The
    ``batch_norm`` variant is not ported yet and raises;
  * :class:`PreNormResidual`: ``x + dropout(layer(layer_norm(x)))``, whose
    dropout and residual add run as kernel B2's ``fused_dropout_add``
    under ``fused_residual_dropout`` (no model of the JAX package builds
    one; it is kernel B2's residual variant's caller).

Dense layers are :class:`Dense`, flax's ``DenseGeneral`` over the last
axis: fp32 parameters, computed in the layer's dtype, lecun-normal
kernels and zero biases, parameters named ``weight`` (out, in) and
``bias``. :func:`dense` rounds as flax does (C26): in bf16 the product
is rounded, then the bias added and rounded again.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import fused_dropout as fd
from ..dropout import dropout
from ..initializers import resolve_initializer

NEG_INF = -1e9


def get_position_encoding(length: int, hidden_size: int,
                          min_timescale: float = 1.0,
                          max_timescale: float = 1.0e4) -> np.ndarray:
    """Sinusoidal position signal, shape (length, hidden_size), fp32."""
    position = np.arange(length, dtype=np.float32)
    num_timescales = hidden_size // 2
    log_increment = (np.log(max_timescale / min_timescale) /
                     max(num_timescales - 1, 1))
    inv_timescales = min_timescale * np.exp(
        np.arange(num_timescales, dtype=np.float32) * -log_increment)
    scaled = position[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def rel_pos_embedding(klen: int, dim: int) -> np.ndarray:
    """Transformer-XL's sinusoids for distances 0 .. klen - 1, shape
    (klen, dim) laid out ``[sin | cos]``, computed in float64 and rounded
    to fp32 at the end (``encoders/transformer_xl_encoder.py:53-60``)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
    pos = np.arange(klen)[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)],
                          axis=1).astype(np.float32)


def position_encoding(length: int, hidden_size: int, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """:func:`get_position_encoding` as a (length, hidden_size) tensor."""
    return torch.from_numpy(get_position_encoding(length, hidden_size)).to(
        device=device, dtype=dtype)


def get_padding_bias(ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """(B, 1, 1, T) additive bias: NEG_INF at padding positions."""
    return ((ids == pad_id).float() * NEG_INF)[:, None, None, :]


def get_decoder_self_attention_bias(length: int, device=None
                                    ) -> torch.Tensor:
    """(1, 1, T, T) causal bias."""
    mask = torch.ones((length, length), device=device).triu(1)
    return (mask * NEG_INF)[None, None]


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python number as JAX applies it to an array of ``dtype`` (a weak
    type: rounded to the array's type first), e.g. sqrt(0.5) times a bf16
    array is 0.70703125 times it; returned as a float that torch applies
    exactly."""
    return float(torch.tensor(value, dtype=dtype))


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x w^T + b`` in the type of ``w`` as flax's ``nn.Dense`` computes
    it: under bf16 the product rounded to bf16, then the bias added and
    rounded again (a bias fused into the product's epilogue rounds once,
    and differs in about a quarter of the bf16 outputs). In fp32 the two
    forms differ only by fp32 rounding, and the fused one is kept."""
    if b is None:
        return F.linear(x, w)
    if w.dtype == torch.float32:
        return F.linear(x, w, b)
    return F.linear(x, w) + b


class Dense(nn.Module):
    """y = x W^T + b over the last axis, in ``dtype`` (:func:`dense`); W
    stored (out, in).

    Without autograd the parameters' cast to ``dtype`` is kept until they
    change, so that a decode loop casts them once, not once per step (XLA
    hoists the same cast out of the JAX package's decode loop); under a
    tracer the cast is part of the traced program."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        resolve_initializer(None)(self.weight, generator)
        self.dtype = dtype
        self._cast = (None, None, None)

    def _params(self):
        w, b = self.weight, self.bias
        if w.dtype == self.dtype:
            return w, b
        if torch.is_grad_enabled() or torch.compiler.is_compiling():
            # a tracer (``torch.export``) records the cast in its program:
            # its fake tensors have no storage to key the cache on
            return w.to(self.dtype), b.to(self.dtype)
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version)
        if self._cast[0] != key:
            self._cast = (key, w.to(self.dtype), b.to(self.dtype))
        return self._cast[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.to(self.dtype), *self._params())


def embed_ids(table: torch.Tensor, ids: torch.Tensor, hidden_size: int,
              dtype: torch.dtype) -> torch.Tensor:
    """ids (B, T) -> (B, T, d) in ``dtype``: rows of the table scaled by
    sqrt(d), zero at pad id 0."""
    emb = F.embedding(ids.long(), table.to(dtype)) * (hidden_size ** 0.5)
    return emb * (ids != 0).to(dtype)[..., None]


def project_logits(table: torch.Tensor, x: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """x (..., d) @ table[:V]^T -> fp32 logits (..., V). As in the JAX
    package the operands are x's dtype (the table rounded to it) and the
    product is fp32: both are upcast, which is exact, and multiplied in
    fp32. Rounding the logits to bf16 would change which beams win."""
    w = table[:vocab_size].to(x.dtype).float()
    return F.linear(x.float(), w)


class SharedEmbedding(nn.Module):
    """Tied input-embedding / output-projection table, ``embedding`` of
    shape (V padded, d), drawn from N(0, d^-1)."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 pad_vocab_to_eight: bool, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        v = (vocab_size + 7) // 8 * 8 if pad_vocab_to_eight else vocab_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(v, hidden_size))
        with torch.no_grad():
            self.embedding.normal_(0.0, hidden_size ** -0.5,
                                   generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_ids(self.embedding, ids, self.hidden_size, self.dtype)


class TransformerNorm(nn.Module):
    """Pre-process normalization of ``norm_params``: the default layer
    norm. Its flax twin wraps an inner ``LayerNorm_0``, which
    ``convert.py`` folds into this module (``flax_inner``)."""
    flax_inner = "LayerNorm_0"

    def __init__(self, hidden_size: int, norm_params=None):
        super().__init__()
        kind = (norm_params or {}).get("type", "layernorm_L2")
        if kind == "batch_norm":
            raise NotImplementedError("norm_params type batch_norm (the "
                                      "Transformer_BatchNorm variant) is "
                                      "not ported yet")
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(),
                            1e-6).to(x.dtype)


class PreNormResidual(nn.Module):
    """``x + dropout(layer(layer_norm(x)))`` (``common.py:119-148``): the
    layer norm ``pre_norm`` (eps 1e-6, fp32 statistics, output in
    ``dtype``), then ``layer(y, *args, train=, generator=, **kwargs)``,
    which may return ``(y, extra)``. In training with ``fused_dropout``,
    a last dim that is a multiple of 128 and ``x`` shaped as ``y``, the
    dropout and the sum are one launch of kernel B2's residual variant,
    seeded from the step's generator; otherwise ``parts/dropout``."""

    def __init__(self, layer: nn.Module, hidden_size: int,
                 dropout_rate: float, dtype: torch.dtype = torch.float32,
                 dropout_bits: int = 32, fused_dropout: bool = False):
        super().__init__()
        self.pre_norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.layer = layer
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.dropout_bits = dropout_bits
        self.fused_dropout = fused_dropout

    def forward(self, x: torch.Tensor, *args, train: bool = False,
                generator: Optional[torch.Generator] = None, **kwargs):
        y = self.pre_norm(x.float()).to(self.dtype)
        y = self.layer(y, *args, train=train, generator=generator, **kwargs)
        extra = None
        if isinstance(y, tuple):
            y, extra = y
        rate = self.dropout_rate
        if train and rate > 0.0 and self.fused_dropout and \
                x.shape == y.shape and fd.supported(y.shape):
            out = fd.fused_dropout_add(x, y, rate,
                                       fd.draw_seed(generator, y.device))
        else:
            if train:
                y = dropout(y, 1.0 - rate, generator, self.dropout_bits)
            out = x + y
        return out if extra is None else (out, extra)
