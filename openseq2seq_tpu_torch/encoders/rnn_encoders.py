"""RNN encoders with embeddings for NMT (port of
``openseq2seq_tpu/encoders/rnn_encoders.py``; reference
`open_seq2seq/encoders/rnn_encoders.py:15,160,320,485`): unidirectional,
bidirectional, and GNMT-like (one bidirectional layer, then
unidirectional layers).

The embedding (V, E), drawn from N(0, 1/E), is cast to the compute type
before the gather, as the JAX module takes it, so its gradient is summed
in the compute type. The recurrent layers are the port's
``parts/rnns/rnn.py`` ``LSTM``, ``GRU`` and ``BiRNN`` in the compute
type; the model key ``fused_rnn`` reaches them explicitly, so that an
LSTM recurrence runs on kernel B3 and a GRU's on B4 wherever the layer's
shape is supported, forward and, in training, backward. In training,
dropout with the model's ``dropout_bits`` goes on each layer's input
(``encoder_dp_input_keep_prob``) and output
(``encoder_dp_output_keep_prob``), drawn from the step's generator.

Layouts, as the JAX module computes them:

  * ``uni``: layers ``rnn1`` ...; a layer's output is added to its input
    with ``encoder_use_skip_connections`` where the widths agree;
  * ``bi``: bidirectional layers ``rnn1`` ..., each (B, T, 2H);
  * ``gnmt``: a bidirectional layer ``bidi``, then ``encoder_layers - 1``
    unidirectional layers ``uni1`` ...; the residual is added from the
    third layer of the stack on (``uni2``), where the widths agree, and
    ``encoder_use_skip_connections`` is ignored, as in the JAX module.

Module and parameter names follow the flax module's (``net/embedding``,
``net/bidi/fw/input_proj``, ``net/uni1/recurrent_kernel`` ...), so that
``convert.py`` maps one onto the other. The keys that have no effect in
the JAX module (``time_major``, ``use_swap_memory``, ``proj_size``,
``num_groups``) are refused, as is a ``core_cell_params`` key other than
``num_units``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from ..parts.dropout import dropout
from ..parts.rnns.rnn import GRU, LSTM, BiRNN

REFUSED = ("time_major", "use_swap_memory", "proj_size", "num_groups")


def cell_type_of(core_cell) -> str:
    """"gru" where the ``core_cell`` name (or class name) holds "gru",
    else "lstm", as the JAX package maps it."""
    name = core_cell if isinstance(core_cell, str) \
        else getattr(core_cell, "__name__", "")
    return "gru" if "gru" in str(name or "lstm").lower() else "lstm"


class RNNEncoderNet(nn.Module):
    """(B, T) ids and (B,) lengths in; (B, T, C) outputs out."""

    def __init__(self, vocab_size: int, emb_size: int, layers: int,
                 units: int, cell_type: str, use_skip_connections: bool,
                 input_keep_prob: float, output_keep_prob: float,
                 layout: str, fused: bool, dropout_bits: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.layout, self.dtype = layout, dtype
        self.use_skip_connections = use_skip_connections
        self.input_keep_prob = input_keep_prob
        self.output_keep_prob = output_keep_prob
        self.dropout_bits = dropout_bits
        self.embedding = nn.Parameter(torch.randn(
            (vocab_size, emb_size), generator=generator) * emb_size ** -0.5)
        cell = GRU if cell_type == "gru" else LSTM

        def uni(width):
            return cell(width, units, dtype=dtype, fused=fused,
                        generator=generator)

        def bi(width):
            return BiRNN(width, units, cell_type, dtype, fused, generator)

        self.names = []
        width = emb_size
        if layout == "gnmt":
            self.bidi = bi(width)
            self.names.append("bidi")
            width = 2 * units
            for i in range(1, layers):
                self.add_module("uni{}".format(i), uni(width))
                self.names.append("uni{}".format(i))
                width = units
        else:
            for i in range(1, layers + 1):
                self.add_module("rnn{}".format(i),
                                bi(width) if layout == "bi" else uni(width))
                self.names.append("rnn{}".format(i))
                width = 2 * units if layout == "bi" else units
        self.out_features = width

    def _layer(self, i: int, x: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        out = self._modules[self.names[i]](x, lengths)
        return out if isinstance(out, torch.Tensor) else out[0]

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None
                ) -> Dict[str, Any]:
        x = F.embedding(ids.long(), self.embedding.to(self.dtype))

        def drop(v, keep):
            return dropout(v, keep, generator, self.dropout_bits) if train \
                else v

        for i in range(len(self.names)):
            h = self._layer(i, drop(x, self.input_keep_prob), lengths)
            if self.layout == "gnmt":
                residual = i >= 2 and h.shape == x.shape
            else:
                residual = (self.layout == "uni" and
                            self.use_skip_connections and
                            h.shape == x.shape)
            x = drop(x + h if residual else h, self.output_keep_prob)
        return {"outputs": x, "src_length": lengths}


class RNNEncoderModule(nn.Module):

    def __init__(self, net: RNNEncoderNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        ids, lengths = input_dict["source_tensors"][:2]
        return self.net(ids, lengths, train, generator)


class _RNNEncoderConfigBase(Encoder):

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "src_vocab_size": int,
            "src_emb_size": int,
            "core_cell": None,
            "core_cell_params": dict,
            "encoder_layers": int,
            "encoder_use_skip_connections": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "encoder_dp_input_keep_prob": float,
            "encoder_dp_output_keep_prob": float,
            "time_major": bool,
            "use_swap_memory": bool,
            "proj_size": int,
            "num_groups": int,
        })

    _layout = "uni"

    def __init__(self, params, model, name="encoder", mode="train"):
        super().__init__(params, model, name, mode)
        refused = [k for k in REFUSED if k in self._params]
        if refused:
            raise ValueError("{} options {} have no effect in the JAX "
                             "package and are refused".format(
                                 type(self).__name__, refused))
        extra = set(self._params["core_cell_params"]) - {"num_units"}
        if extra:
            raise NotImplementedError("core_cell_params {} are not ported "
                                      "yet".format(sorted(extra)))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> RNNEncoderModule:
        """``in_features`` is unused: the inputs are ids."""
        p = self._params
        model = {} if self._model is None else self._model.params
        return RNNEncoderModule(RNNEncoderNet(
            vocab_size=p["src_vocab_size"],
            emb_size=p["src_emb_size"],
            layers=p["encoder_layers"],
            units=p["core_cell_params"].get("num_units", p["src_emb_size"]),
            cell_type=cell_type_of(p["core_cell"]),
            use_skip_connections=p["encoder_use_skip_connections"],
            input_keep_prob=p.get("encoder_dp_input_keep_prob", 1.0),
            output_keep_prob=p.get("encoder_dp_output_keep_prob", 1.0),
            layout=self._layout,
            fused=bool(model.get("fused_rnn", False)),
            dropout_bits=model.get("dropout_bits", 32),
            dtype=self.compute_dtype,
            generator=generator))


class UnidirectionalRNNEncoderWithEmbedding(_RNNEncoderConfigBase):
    """Reference `rnn_encoders.py:15`."""
    _layout = "uni"


class BidirectionalRNNEncoderWithEmbedding(_RNNEncoderConfigBase):
    """Reference `rnn_encoders.py:160`."""
    _layout = "bi"


class GNMTLikeEncoderWithEmbedding(_RNNEncoderConfigBase):
    """Reference `rnn_encoders.py:320`, and its cuDNN variant at `:485`,
    the same computation."""
    _layout = "gnmt"


GNMTLikeEncoderWithEmbedding_cuDNN = GNMTLikeEncoderWithEmbedding
