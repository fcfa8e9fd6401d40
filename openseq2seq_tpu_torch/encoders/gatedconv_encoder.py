"""Gated-conv ASR encoder (port of
``openseq2seq_tpu/encoders/gatedconv_encoder.py``), the encoder that
``docs/extending-walkthrough.md`` builds: a stride-2 SAME conv front end,
then N residual blocks of layer norm, a conv to twice the width, a gated
linear unit and dropout, then the time mask. It has no reference
counterpart.

Module and parameter names are the flax module's (``front``,
``LayerNorm_{i}``, ``conv{i}``), so ``convert.py`` maps one onto the
other. The layer norms are flax's defaults (epsilon 1e-6, fp32
statistics, output in the compute dtype); the convs round as flax's bf16
``nn.Conv`` does (``SameConv1d``); the GLU's sigmoid is rounded to the
compute dtype before its product, as ``nn.glu`` computes it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from .tdnn_encoder import SameConv1d, _mask_time, _out_length
from ..parts.dropout import dropout


class GatedConvNet(nn.Module):
    """(B, T, F) features and (B,) lengths in, (B, ceil(T / 2), H) and
    lengths out."""

    def __init__(self, in_features: int, num_layers: int, hidden_size: int,
                 kernel_size: int, keep_prob: float, dropout_bits: int,
                 dtype: torch.dtype, kernel_init,
                 generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        self.keep_prob = keep_prob
        self.dropout_bits = dropout_bits
        self.dtype = dtype
        self.front = SameConv1d(in_features, hidden_size, kernel_size, 2, 1,
                                dtype, kernel_init, generator)
        for i in range(num_layers):
            self.add_module("LayerNorm_{}".format(i),
                            nn.LayerNorm(hidden_size, eps=1e-6))
            self.add_module("conv{}".format(i), SameConv1d(
                hidden_size, 2 * hidden_size, kernel_size, 1, 1, dtype,
                kernel_init, generator))
        self.out_features = hidden_size

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool,
                generator: torch.Generator = None):
        m = self._modules
        x = self.front(x.to(self.dtype))
        lengths = _out_length(lengths, 2)
        for i in range(self.num_layers):
            ln = m["LayerNorm_{}".format(i)]
            h = F.layer_norm(x.float(), ln.normalized_shape,
                             ln.weight.float(), ln.bias.float(),
                             ln.eps).to(self.dtype)
            a, b = m["conv{}".format(i)](h).chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
            if train:
                h = dropout(h, self.keep_prob, generator, self.dropout_bits)
            x = x + h
        # padded frames zeroed for the CTC or attention downstream
        return _mask_time(x, lengths), lengths


class GatedConvEncoderModule(nn.Module):

    def __init__(self, net: GatedConvNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(x, lengths, train, generator)
        return {"outputs": outputs, "src_length": out_len}


class GatedConvEncoder(Encoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "num_layers": int,
            "hidden_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "kernel_size": int,
            "dropout_keep_prob": float,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> GatedConvEncoderModule:
        from ..parts.initializers import resolve_initializer
        p = self._params
        model = {} if self._model is None else self._model.params
        return GatedConvEncoderModule(GatedConvNet(
            in_features=in_features,
            num_layers=p["num_layers"],
            hidden_size=p["hidden_size"],
            kernel_size=p.get("kernel_size", 5),
            keep_prob=p.get("dropout_keep_prob", 0.9),
            dropout_bits=model.get("dropout_bits", 32),
            dtype=self.compute_dtype,
            # the JAX module's convs take flax's default initializer
            kernel_init=resolve_initializer(None),
            generator=generator))
