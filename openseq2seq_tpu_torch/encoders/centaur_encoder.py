"""Centaur encoder (port of ``openseq2seq_tpu/encoders/centaur_encoder.py``):
a character embedding, blocks of conv, batch norm, relu and dropout, and a
dense projection to ``output_size``.

What the JAX module computes, and so the port:

  * the ``embedding`` table (V, E), an fp32 leaf drawn from N(0, 0.1^2),
    rounded to the compute type and then gathered;
  * before each conv the time mask (zeros past each length); the conv
    (``conv{i}``, a :class:`SameConv1d` for the recipes' SAME padding, a
    :class:`CausalConv1d` for CAUSAL), its batch norm (``bn{i}``, flax's
    momentum 0.95 and epsilon 1e-8 by default), relu and, in training,
    dropout at ``cnn_dropout_prob`` from the step's generator with the
    model's ``dropout_bits``;
  * the projection ``proj`` (a dense layer), then the mask again; the
    lengths pass through unchanged.

``pad_embeddings_2_eight`` and ``norm_type`` are accepted with no effect,
as in the JAX module, which reads neither.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from .tdnn_encoder import BatchNorm, CausalConv1d, SameConv1d, _mask_time
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import Dense

CONVS = {"SAME": SameConv1d, "CAUSAL": CausalConv1d}


def conv_class(spec: Dict[str, Any]):
    """The conv layer of a ``conv_layers`` entry's padding."""
    padding = spec.get("padding", "SAME")
    if padding not in CONVS:
        raise NotImplementedError(
            "only SAME and CAUSAL convs are ported; got {!r}".format(padding))
    return CONVS[padding]


class CentaurEncoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], dtype: torch.dtype,
                 generator: torch.Generator, dropout_bits: int = 32):
        super().__init__()
        E = p["embedding_size"]
        self.embedding = nn.Parameter(torch.empty(p["src_vocab_size"], E))
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.1, generator=generator)
        self.dtype = dtype
        self.dropout_keep = 1.0 - p.get("cnn_dropout_prob", 0.5)
        self.dropout_bits = dropout_bits
        momentum = p.get("bn_momentum", 0.95)
        eps = p.get("bn_epsilon", 1e-8)
        width = E
        self.num_convs = len(p["conv_layers"])
        for i, spec in enumerate(p["conv_layers"], start=1):
            ch = spec["num_channels"]
            self.add_module("conv{}".format(i), conv_class(spec)(
                width, ch, spec["kernel_size"][0],
                spec.get("stride", [1])[0], 1, dtype,
                resolve_initializer(None), generator))
            # flax momentum is the decay of the running average
            self.add_module("bn{}".format(i),
                            BatchNorm(ch, 1.0 - momentum, eps, dtype))
            width = ch
        self.proj = Dense(width, p["output_size"], dtype, generator)
        self.out_features = p["output_size"]

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        ids, lengths = input_dict["source_tensors"][:2]
        x = F.embedding(ids.long(), self.embedding.to(self.dtype))
        for i in range(1, self.num_convs + 1):
            x = _mask_time(x, lengths)
            x = getattr(self, "conv{}".format(i))(x)
            x = torch.relu(getattr(self, "bn{}".format(i))(x, train))
            if train:
                x = dropout(x, self.dropout_keep, generator,
                            self.dropout_bits)
        x = _mask_time(self.proj(x), lengths)
        return {"outputs": x, "src_length": lengths}


class CentaurEncoder(Encoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "src_vocab_size": int,
            "embedding_size": int,
            "output_size": int,
            "conv_layers": list,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "pad_embeddings_2_eight": bool,
            "bn_momentum": float,
            "bn_epsilon": float,
            "cnn_dropout_prob": float,
            "norm_type": str,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> CentaurEncoderModule:
        """``in_features`` is unused: the input is character ids."""
        model = self._model.params if self._model is not None else {}
        return CentaurEncoderModule(self._params, self.compute_dtype,
                                    generator,
                                    model.get("dropout_bits", 32))
