"""DeepSpeech-2 encoder (port of ``openseq2seq_tpu/encoders/ds2_encoder.py``).

A stack of 2-D convolutions over the (time, frequency) plane, each with
batch norm and the activation, then a stack of (bi)directional recurrent
layers (``parts/rnns/rnn.py``), then one fully-connected layer and the
activation. Module and parameter names follow the flax module's
(``conv{i}``, ``conv{i}_bn``, ``rnn{i}`` with ``fw``/``bw``,
``fully_connected``) so that ``convert.py`` maps one onto the other.

Kept from the JAX package, each a trap when porting:
  * the data stays (B, T, F, C), channels last: each conv runs as a 2-D
    conv over a channels-last (B, C, T, F) view of it, so cuDNN takes its
    NHWC kernels, and returns (B, T', F', C') again;
  * SAME padding is XLA's in both dimensions, low = total // 2, so a
    stride-2 conv pads asymmetrically (``tdnn_encoder.same_padding``);
    nothing is masked between the convs, so padded frames reach valid
    ones through the receptive field, as there;
  * batch norm takes eps 1e-3 and flax's momentum 0.99 (torch's 0.01) by
    default, normalizing in fp32 (``tdnn_encoder.BatchNorm``);
  * only the time stride changes the lengths, to ceil(len / stride);
  * (B, T, F, C) is flattened to F·C with C fastest, as flax reshapes it,
    and the time mask is applied after the conv stack and after the
    fully-connected layer (the recurrent layers mask their own outputs).

The model key ``fused_rnn`` reaches the recurrent layers explicitly: the
GRU and LSTM recurrences then run on the hand-written kernels B4 and B3,
forward and backward, where the JAX package would run its Pallas kernels.

In training, batch norm normalizes with the batch's statistics per
channel over B x T x F and updates the running ones the flax way
(``tdnn_encoder.BatchNorm``), and dropout (``parts/dropout.py``, with the
model's ``dropout_bits``) draws from the ``torch.Generator`` passed to
``forward`` at the JAX module's three sites: after the conv stack and its
time mask, after each recurrent layer, and after the fully-connected
layer's activation, before the last mask. The JAX module's
``checkpoint_name`` (a remat anchor) has no counterpart: PyTorch keeps
what autograd needs. ``row_conv`` is refused (no recipe sets it).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from .tdnn_encoder import (BatchNorm, _mask_time, _out_length,
                           resolve_activation, same_padding)
from ..decoders.fc_decoders import Dense
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.rnns.rnn import GRU, LSTM, make_rnn


class SameConv2d(nn.Module):
    """flax ``nn.Conv`` with SAME padding over (B, T, F, C), computing in
    ``dtype`` from the stored params; the weight is stored (out, in, kt,
    kf), as torch's conv2d keeps it. With ``use_bias`` (flax's default)
    the bias is added after the conv as flax rounds it (C26: under bf16
    the conv's output rounded, then the sum; fp32 keeps the fused form).
    ``padding`` "VALID" pads nothing."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride,
                 dtype: torch.dtype, kernel_init,
                 generator: torch.Generator, use_bias: bool = True,
                 padding: str = "SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        kernel_init(self.weight, generator)
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kt, kf), (st, sf) = self.kernel, self.stride
        x = x.to(self.dtype)
        if self.padding == "SAME":
            t_lo, t_hi = same_padding(x.shape[1], kt, st, 1)
            f_lo, f_hi = same_padding(x.shape[2], kf, sf, 1)
            x = F.pad(x, (0, 0, f_lo, f_hi, t_lo, t_hi))
        b = None if self.bias is None else self.bias.to(self.dtype)
        fused = self.dtype == torch.float32
        # (B, T, F, C) contiguous is (B, C, T, F) in channels-last order
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     self.weight.to(dtype=self.dtype,
                                    memory_format=torch.channels_last),
                     b if fused else None, self.stride).permute(0, 2, 3, 1)
        return y if fused or b is None else y + b


class DS2Net(nn.Module):
    """The module behind :class:`DeepSpeech2Encoder`: (B, T, F) features
    and (B,) lengths in, (B, T', n_hidden) outputs and (B,) lengths
    out."""

    def __init__(self, in_features: int, conv_layers, num_rnn_layers: int,
                 rnn_cell_dim: int, rnn_type: str, rnn_unidirectional: bool,
                 n_hidden: int, activation_fn, bn_momentum: float,
                 bn_epsilon: float, fused_rnn: bool, dropout_keep_prob: float,
                 dropout_bits: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.activation_fn = activation_fn
        self.keep_prob, self.dropout_bits = dropout_keep_prob, dropout_bits
        self.dtype = dtype
        kernel_init = resolve_initializer(None)
        self.time_strides = []
        ch, freq = 1, in_features
        for i, spec in enumerate(conv_layers, start=1):
            if spec.get("padding", "SAME") != "SAME":
                raise NotImplementedError("only SAME conv padding is "
                                          "ported; got {}".format(
                                              spec["padding"]))
            out_ch = spec["num_channels"]
            self.add_module("conv{}".format(i), SameConv2d(
                ch, out_ch, spec["kernel_size"], spec["stride"], dtype,
                kernel_init, generator))
            # flax momentum is the decay of the running average; torch's
            # is the weight of the new batch
            self.add_module("conv{}_bn".format(i), BatchNorm(
                out_ch, 1.0 - bn_momentum, bn_epsilon, dtype))
            self.time_strides.append(spec["stride"][0])
            ch, freq = out_ch, -(-freq // spec["stride"][1])
        width = ch * freq
        for i in range(1, num_rnn_layers + 1):
            if not rnn_unidirectional:
                layer = make_rnn(rnn_type, width, rnn_cell_dim, False, dtype,
                                 fused_rnn, generator)
            elif rnn_type in ("gru", "cudnn_gru"):
                layer = GRU(width, rnn_cell_dim, dtype=dtype, fused=fused_rnn,
                            generator=generator)
            else:
                layer = LSTM(width, rnn_cell_dim, dtype=dtype,
                             fused=fused_rnn, generator=generator)
            self.add_module("rnn{}".format(i), layer)
            width = rnn_cell_dim * (1 if rnn_unidirectional else 2)
        self.num_conv, self.num_rnn = len(conv_layers), num_rnn_layers
        self.unidirectional = rnn_unidirectional
        self.fully_connected = Dense(width, n_hidden, dtype, kernel_init,
                                     generator)
        self.out_features = n_hidden

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None):
        """``generator`` draws the dropout masks in training (on ``x``'s
        device)."""
        m = self._modules

        def drop(v):
            if not train:
                return v
            return dropout(v, self.keep_prob, generator, self.dropout_bits)

        x = x.to(self.dtype)[..., None]                     # (B, T, F, 1)
        for i in range(1, self.num_conv + 1):
            x = m["conv{}".format(i)](x)
            x = self.activation_fn(m["conv{}_bn".format(i)](x, train))
            if self.time_strides[i - 1] > 1:
                lengths = _out_length(lengths, self.time_strides[i - 1])
        B, T, Fq, C = x.shape
        x = drop(_mask_time(x.reshape(B, T, Fq * C), lengths))
        for i in range(1, self.num_rnn + 1):
            x = m["rnn{}".format(i)](x, lengths)
            if self.unidirectional:
                x = x[0]
            x = drop(x)
        x = drop(self.activation_fn(self.fully_connected(x)))
        return _mask_time(x, lengths), lengths


class DS2EncoderModule(nn.Module):

    def __init__(self, net: DS2Net):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(x, lengths, train, generator)
        return {"outputs": outputs, "src_length": out_len}


class DeepSpeech2Encoder(Encoder):
    """Config wrapper, same schema as the JAX package's."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "dropout_keep_prob": float,
            "conv_layers": list,
            "activation_fn": None,
            "num_rnn_layers": int,
            "row_conv": bool,
            "n_hidden": int,
            "use_cudnn_rnn": bool,
            "rnn_cell_dim": int,
            "rnn_type": ["layernorm_lstm", "lstm", "gru",
                         "cudnn_gru", "cudnn_lstm"],
            "rnn_unidirectional": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "row_conv_width": int,
            "data_format": ["channels_first", "channels_last",
                            "BCTF", "BTFC", "BCFT", "BFTC"],
            "bn_momentum": float,
            "bn_epsilon": float,
        })

    def __init__(self, params, model, name="ds2_encoder", mode="train"):
        super().__init__(params, model, name, mode)
        if self._params["row_conv"]:
            raise NotImplementedError("row_conv is not ported yet")

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> DS2EncoderModule:
        p = self._params
        fused = self._model is not None and \
            bool(self._model.params.get("fused_rnn", False))
        return DS2EncoderModule(DS2Net(
            in_features=in_features,
            conv_layers=p["conv_layers"],
            num_rnn_layers=p["num_rnn_layers"],
            rnn_cell_dim=p["rnn_cell_dim"],
            rnn_type=p["rnn_type"],
            rnn_unidirectional=p["rnn_unidirectional"],
            n_hidden=p["n_hidden"],
            activation_fn=resolve_activation(p["activation_fn"]),
            bn_momentum=p.get("bn_momentum", 0.99),
            bn_epsilon=p.get("bn_epsilon", 1e-3),
            fused_rnn=fused,
            dropout_keep_prob=p["dropout_keep_prob"],
            dropout_bits=32 if self._model is None
            else self._model.params.get("dropout_bits", 32),
            dtype=self.compute_dtype,
            generator=generator))
