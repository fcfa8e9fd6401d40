"""Listen-Attend-Spell encoder (port of
``openseq2seq_tpu/encoders/las_encoder.py``; reference
`open_seq2seq/encoders/las_encoder.py:49-238`): a conv "listener" front
end, then recurrent layers described by ``recurrent_layers`` specs, each
with an optional time pooling (the LAS pyramid).

What the JAX module computes, and so the port:

  * the listener is the TDNN encoder's net (``listener_convs``) with its
    time mask on (``use_conv_mask``), no block drop, batch norm with the
    momentum 0.90 and epsilon 1e-3 defaults;
  * a spec's ``pool`` > 1 cuts T to a multiple of ``pool``, folds each
    ``pool`` frames into one, (B, T / pool, pool D), and sets the lengths
    to ``max(l // pool, 1)``;
  * then a bidirectional layer (``BiRNN``, (B, T, 2H)) or, with
    ``unidirectional``, a ``GRU`` or ``LSTM``, named ``rnn{i}``; the model
    key ``fused_rnn`` reaches them explicitly, so that in the "mixed"
    recipes each LSTM recurrence runs on kernel B3 (``ops/lstm_scan.py``)
    forward and, in training, backward;
  * in training, dropout after each recurrent layer at the spec's
    ``dropout_keep_prob`` (else the encoder's), an exact Bernoulli mask
    (flax's ``nn.Dropout``) drawn from the step's generator;
  * the time mask at the end.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .encoder import Encoder
from .tdnn_encoder import TDNNNet, _mask_time, resolve_activation
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.rnns.rnn import GRU, LSTM, BiRNN


class LASNet(nn.Module):
    """(B, T, F) features and (B,) lengths in, (B, T', C) and lengths
    out."""

    def __init__(self, in_features: int, convnet_layers, recurrent_layers,
                 activation_fn, dropout_keep_prob: float, bn_momentum: float,
                 bn_epsilon: float, dropout_bits: int, fused: bool,
                 dtype: torch.dtype, kernel_init,
                 generator: torch.Generator):
        super().__init__()
        self.listener_convs = TDNNNet(
            in_features=in_features, convnet_layers=convnet_layers,
            activation_fn=activation_fn,
            dropout_keep_prob=dropout_keep_prob, bn_momentum=bn_momentum,
            bn_epsilon=bn_epsilon, use_conv_mask=True, drop_block_prob=0.0,
            drop_block_index=-1, dropout_bits=dropout_bits, dtype=dtype,
            kernel_init=kernel_init, generator=generator)
        self.plan = []
        width = self.listener_convs.out_features
        for i, spec in enumerate(recurrent_layers, start=1):
            units = spec["num_units"]
            cell_type = str(spec.get("type", "lstm")).lower()
            pool = spec.get("pool", 1)
            if pool > 1:
                width *= pool
            if not spec.get("unidirectional", False):
                layer = BiRNN(width, units, cell_type, dtype, fused,
                              generator)
                width = 2 * units
            else:
                cell = GRU if cell_type == "gru" else LSTM
                layer = cell(width, units, dtype=dtype, fused=fused,
                             generator=generator)
                width = units
            self.add_module("rnn{}".format(i), layer)
            self.plan.append((pool, spec.get("dropout_keep_prob",
                                             dropout_keep_prob)))
        self.out_features = width

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool,
                generator: torch.Generator = None):
        x, lengths = self.listener_convs(x, lengths, train, generator)
        for i, (pool, keep) in enumerate(self.plan, start=1):
            if pool > 1:
                T = x.shape[1] // pool * pool
                x = x[:, :T].reshape(x.shape[0], T // pool,
                                     pool * x.shape[2])
                lengths = torch.clamp(lengths // pool, min=1)
            out = self._modules["rnn{}".format(i)](x, lengths)
            x = out if isinstance(out, torch.Tensor) else out[0]
            if train:
                x = dropout(x, keep, generator)
        return _mask_time(x, lengths), lengths


class LASEncoderModule(nn.Module):

    def __init__(self, net: LASNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(x, lengths, train, generator)
        return {"outputs": outputs, "src_length": out_len}


class ListenAttendSpellEncoder(Encoder):
    """Config wrapper, the JAX package's schema (reference
    `las_encoder.py:55-70`). ``normalization`` other than batch norm
    raises, as the TDNN encoder's does."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "dropout_keep_prob": float,
            "recurrent_layers": list,
            "convnet_layers": list,
            "activation_fn": None,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "data_format": ["channels_first", "channels_last"],
            "normalization": [None, "batch_norm"],
            "bn_momentum": float,
            "bn_epsilon": float,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> LASEncoderModule:
        p = self._params
        if p.get("normalization", "batch_norm") != "batch_norm":
            raise NotImplementedError(
                "only normalization='batch_norm' is ported")
        model = {} if self._model is None else self._model.params
        return LASEncoderModule(LASNet(
            in_features=in_features,
            convnet_layers=p["convnet_layers"],
            recurrent_layers=p["recurrent_layers"],
            activation_fn=resolve_activation(p["activation_fn"]),
            dropout_keep_prob=p["dropout_keep_prob"],
            bn_momentum=p.get("bn_momentum", 0.90),
            bn_epsilon=p.get("bn_epsilon", 1e-3),
            dropout_bits=model.get("dropout_bits", 32),
            fused=bool(model.get("fused_rnn", False)),
            dtype=self.compute_dtype,
            kernel_init=resolve_initializer(p.get("initializer"),
                                            p.get("initializer_params")),
            generator=generator))
