"""Tacotron-2 encoder, with Global Style Tokens (port of
``openseq2seq_tpu/encoders/tacotron2_encoder.py``).

:class:`Tacotron2Net`: a character embedding (N(0, 0.25) init, cast to
the compute type before the gather), then for each of ``conv_layers`` the
time mask, a SAME conv, batch norm (flax's ``momentum``, 0.1 by default,
is the decay of the running averages: torch's is its complement; epsilon
1e-5; the biased batch variance, as ``tdnn_encoder.BatchNorm`` keeps it),
the activation and dropout; then ``num_rnn_layers`` bidirectional
recurrent layers (``parts/rnns/rnn.BiRNN``: LSTM cells, or GRU ones where
``rnn_type`` names a GRU), each followed by dropout, and the time mask.
The model key ``fused_rnn`` reaches the layers, so that both directions
of an LSTM run on kernel B3 wherever its shape is supported, forward and,
in training, backward.

:class:`GSTNet`: the style spectrogram (B, T, F) through 3x3 stride-2
SAME 2-D convs, each with batch norm (flax's defaults: momentum 0.99,
epsilon 1e-5) and a relu, flattened per frame to a GRU (module
``ref_gru``; B4 under ``fused_rnn``) over the T / 2^n frames, whose last
state queries ``attention_heads``-headed attention over ``tanh(
style_tokens)``: the style embedding, broadcast over the encoder's time
and concatenated to its outputs. The style spectrogram is the batch's
``style_spec`` or else its target spectrogram.

A GST model without either (infer from text alone) is refused (C24): the
JAX module then leaves the style out, so its outputs narrow and the
decoder built on them cannot take the trained weights.

Accepted with no effect, as in the JAX module, which reads none of them:
``zoneout_prob``, ``use_cudnn_rnn`` and ``rnn_unidirectional`` (the
layers are bidirectional whatever it says). ``data_format`` has no effect
there either and no recipe sets it: it is refused.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ds2_encoder import SameConv2d
from .encoder import Encoder
from .tdnn_encoder import (BatchNorm, SameConv1d, _mask_time, _out_length,
                           resolve_activation)
from ..decoders.fc_decoders import Dense
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.rnns.rnn import GRU, BiRNN

REFUSED = ("data_format",)


class GSTNet(nn.Module):
    """The style embedding of a (B, T, F) spectrogram: (B, num_units) in
    the compute type."""

    def __init__(self, in_features: int, num_tokens: int, num_units: int,
                 num_heads: int, conv_channels, rnn_units: int, fused: bool,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.dh = num_units // num_heads
        kernel_init = resolve_initializer(None)
        self.n_convs = len(conv_channels)
        ch, freq = 1, in_features
        for i, out_ch in enumerate(conv_channels, start=1):
            self.add_module("ref_conv{}".format(i), SameConv2d(
                ch, out_ch, (3, 3), (2, 2), dtype, kernel_init, generator))
            # flax's default momentum 0.99 is torch's 0.01
            self.add_module("ref_bn{}".format(i),
                            BatchNorm(out_ch, 0.01, 1e-5, dtype))
            ch, freq = out_ch, -(-freq // 2)
        self.ref_gru = GRU(freq * ch, rnn_units, dtype=dtype, fused=fused,
                           generator=generator)
        self.style_tokens = nn.Parameter(torch.randn(
            (num_tokens, self.dh), generator=generator) * 0.3)
        self.style_q = Dense(rnn_units, num_units, torch.float32,
                             kernel_init, generator)
        self.style_k = Dense(self.dh, num_units, torch.float32, kernel_init,
                             generator)

    def forward(self, style_spec: torch.Tensor, train: bool) -> torch.Tensor:
        m = self._modules
        x = style_spec.to(self.dtype)[..., None]          # (B, T, F, 1)
        for i in range(1, self.n_convs + 1):
            x = m["ref_conv{}".format(i)](x)
            x = torch.relu(m["ref_bn{}".format(i)](x, train))
        B, T, Fr, C = x.shape
        x = x.reshape(B, T, Fr * C)
        _, last = self.ref_gru(x, torch.full((B,), T, dtype=torch.int32,
                                             device=x.device))
        query = last.float()
        tokens = torch.tanh(self.style_tokens)
        N, H, dh = tokens.shape[0], self.num_heads, self.dh
        q = self.style_q(query).reshape(B, H, dh)
        keys = self.style_k(tokens).reshape(N, H, dh)
        scores = torch.einsum("bhd,nhd->bhn", q * dh ** -0.5, keys)
        w = torch.softmax(scores, dim=-1)
        style = torch.einsum("bhn,nd->bhd", w, tokens).reshape(B, -1)
        return style.to(self.dtype)


class Tacotron2Net(nn.Module):
    """(B, S) character ids and (B,) lengths in; (B, S', 2 rnn_cell_dim)
    outputs and lengths out."""

    def __init__(self, src_vocab_size: int, src_emb_size: int, conv_layers,
                 activation_fn, cnn_dropout_prob: float,
                 rnn_dropout_prob: float, num_rnn_layers: int,
                 rnn_cell_dim: int, rnn_type: str, bn_momentum: float,
                 bn_epsilon: float, fused: bool, dropout_bits: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.activation_fn = activation_fn
        self.cnn_keep, self.rnn_keep = 1.0 - cnn_dropout_prob, \
            1.0 - rnn_dropout_prob
        self.dropout_bits, self.dtype = dropout_bits, dtype
        self.embedding = nn.Parameter(torch.randn(
            (src_vocab_size, src_emb_size), generator=generator) * 0.5)
        kernel_init = resolve_initializer(None)
        self.strides = []
        width = src_emb_size
        for i, spec in enumerate(conv_layers, start=1):
            if spec.get("padding", "SAME") != "SAME":
                raise NotImplementedError("only SAME conv padding is "
                                          "ported; got {}".format(
                                              spec["padding"]))
            s = spec.get("stride", [1])[0]
            self.add_module("conv{}".format(i), SameConv1d(
                width, spec["num_channels"], spec["kernel_size"][0], s, 1,
                dtype, kernel_init, generator))
            # flax momentum is the decay of the running average; torch's
            # is the weight of the new batch
            self.add_module("bn{}".format(i), BatchNorm(
                spec["num_channels"], 1.0 - bn_momentum, bn_epsilon, dtype))
            self.strides.append(s)
            width = spec["num_channels"]
        self.n_rnn = num_rnn_layers
        for i in range(1, num_rnn_layers + 1):
            self.add_module("rnn{}".format(i), BiRNN(
                width, rnn_cell_dim, rnn_type, dtype, fused, generator))
            width = 2 * rnn_cell_dim
        self.out_features = width

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor, train: bool,
                generator: torch.Generator = None):
        m = self._modules

        def drop(v, keep):
            return dropout(v, keep, generator, self.dropout_bits) if train \
                else v

        x = F.embedding(ids.long(), self.embedding.to(self.dtype))
        for i, s in enumerate(self.strides, start=1):
            x = _mask_time(x, lengths)
            x = m["conv{}".format(i)](x)
            x = self.activation_fn(m["bn{}".format(i)](x, train))
            x = drop(x, self.cnn_keep)
            if s > 1:
                lengths = _out_length(lengths, s)
        for i in range(1, self.n_rnn + 1):
            x = drop(m["rnn{}".format(i)](x, lengths), self.rnn_keep)
        return _mask_time(x, lengths), lengths


class Tacotron2EncoderModule(nn.Module):

    def __init__(self, net: Tacotron2Net, gst: GSTNet = None,
                 style_units: int = 0):
        super().__init__()
        self.net = net
        if gst is not None:
            self.gst = gst
        self.has_gst = gst is not None
        self.out_features = net.out_features + style_units

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        ids, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(ids, lengths, train, generator)
        if self.has_gst:
            style_spec = input_dict.get("style_spec")
            if style_spec is None and \
                    input_dict.get("target_tensors") is not None:
                style_spec = input_dict["target_tensors"][0]
            if style_spec is None:
                raise ValueError(
                    "a GST model needs a style spectrogram (the batch's "
                    "style_spec or its targets); without one the JAX "
                    "package leaves the style out and its decoder cannot "
                    "take the trained weights (C24)")
            style = self.gst(style_spec, train)
            outputs = torch.cat([outputs, style[:, None, :].expand(
                -1, outputs.shape[1], -1)], dim=-1)
        return {"outputs": outputs, "src_length": out_len}


class Tacotron2Encoder(Encoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "cnn_dropout_prob": float,
            "rnn_dropout_prob": float,
            "src_emb_size": int,
            "conv_layers": list,
            "activation_fn": None,
            "num_rnn_layers": int,
            "rnn_cell_dim": int,
            "use_cudnn_rnn": bool,
            "rnn_type": None,
            "rnn_unidirectional": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "data_format": ["channels_first", "channels_last"],
            "bn_momentum": float,
            "bn_epsilon": float,
            "zoneout_prob": float,
            "style_embedding_enable": bool,
            "style_embedding_params": dict,
            "src_vocab_size": int,
        })

    def __init__(self, params, model, name="encoder", mode="train"):
        super().__init__(params, model, name, mode)
        refused = [k for k in REFUSED if k in self._params]
        if refused:
            raise ValueError("{} options {} have no effect in the JAX "
                             "package and are refused".format(
                                 type(self).__name__, refused))

    def make_module(self, in_features: int, generator: torch.Generator
                    ) -> Tacotron2EncoderModule:
        """``in_features`` is the spectrogram's width, which the style
        encoder reads; the text inputs are ids."""
        p = self._params
        model = {} if self._model is None else self._model.params
        fused = bool(model.get("fused_rnn", False))
        rnn_type = str(p.get("rnn_type", "lstm")).lower()
        net = Tacotron2Net(
            src_vocab_size=p["src_vocab_size"],
            src_emb_size=p["src_emb_size"],
            conv_layers=p["conv_layers"],
            activation_fn=resolve_activation(p["activation_fn"]),
            cnn_dropout_prob=p["cnn_dropout_prob"],
            rnn_dropout_prob=p["rnn_dropout_prob"],
            num_rnn_layers=p["num_rnn_layers"],
            rnn_cell_dim=p["rnn_cell_dim"],
            rnn_type="gru" if "gru" in rnn_type else "lstm",
            bn_momentum=p.get("bn_momentum", 0.1),
            bn_epsilon=p.get("bn_epsilon", 1e-5),
            fused=fused, dropout_bits=model.get("dropout_bits", 32),
            dtype=self.compute_dtype, generator=generator)
        if not p.get("style_embedding_enable", False):
            return Tacotron2EncoderModule(net)
        sp = p.get("style_embedding_params", {})
        units = sp.get("num_units", 128)
        gst = GSTNet(in_features=in_features,
                     num_tokens=sp.get("num_tokens", 10), num_units=units,
                     num_heads=sp.get("attention_heads", 4),
                     conv_channels=sp.get("conv_layers", [32, 32, 64, 64]),
                     rnn_units=sp.get("num_rnn_units", 128), fused=fused,
                     dtype=self.compute_dtype, generator=generator)
        return Tacotron2EncoderModule(net, gst, units)
