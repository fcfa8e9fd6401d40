"""Language-model encoder (port of
``openseq2seq_tpu/encoders/lm_encoders.py``).

An embedding, a stack of unidirectional LSTM (or GRU) layers
(``parts/rnns/rnn.py``) and, in LM mode, the vocabulary projection: the
encoder itself produces the logits, and the decoder is the pass-through
``FakeDecoder``. Module and parameter names follow the flax module's
(``embedding``, ``rnn{i}``, ``softmax`` or, with the weights tied to the
embedding, ``softmax_bias``) so that ``convert.py`` maps one onto the
other.

In training, dropout draws from the ``torch.Generator`` passed to
``forward`` at the JAX module's sites: the embedding's whole-word dropout
(one keep draw per vocabulary entry, ``parts/dropout.word_dropout_scale``),
then before each layer its input dropout and after it its output dropout
(the last layer's own keep probability), each one (B, 1, D) mask shared
over time (``parts/dropout.dropout`` with ``broadcast_dims=(1,)``).

In training with ``0 < num_sampled < vocab_size`` the module emits the
sampled-softmax bundle and no (B, T, V) logits: the softmax ``weights``
(V, E) and ``bias`` in fp32, the last layer's outputs as fp32 ``inputs``,
``num_sampled`` and the step's ``generator``, which draws the candidates
in ``losses/sequence_loss.py`` (the JAX module hands its loss a
``sample_rng`` from the same stream). Otherwise it emits fp32 logits,
computed in fp32 from fp32 weights whatever the compute type.

The model key ``fused_rnn`` reaches the recurrent layers explicitly: the
LSTM recurrences then run on kernel B3, forward and backward, where the
JAX package would run its Pallas kernel. Not ported yet, each refused
with the slice that brings it: the ``slstm``, ``flstm`` and layer-norm
LSTM cells (``parts/rnns/rnn._NotPorted``), classification
(``lm_mode: False``) and skip connections, which the JAX module ignores.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from ..decoders.fc_decoders import Dense
from ..parts.dropout import dropout, word_dropout_scale
from ..parts.initializers import resolve_initializer
from ..parts.rnns.rnn import GRU, LSTM, FLSTM, LayerNormLSTM, SLSTM


class LMNet(nn.Module):
    """The module behind :class:`LMEncoder`: (B, T) ids and (B,) lengths
    in; the last layer's outputs, the lengths and the logits or the
    sampled-softmax bundle out."""

    def __init__(self, vocab_size: int, emb_size: int, encoder_layers: int,
                 hidden_size: int, weight_tied: bool, cell_type: str,
                 emb_keep_prob: float, input_keep_prob: float,
                 output_keep_prob: float, last_output_keep_prob: float,
                 num_sampled: int, fused_rnn: bool, dropout_bits: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.vocab_size, self.num_sampled = vocab_size, num_sampled
        self.emb_keep_prob, self.input_keep_prob = emb_keep_prob, \
            input_keep_prob
        self.output_keep_prob = output_keep_prob
        self.last_output_keep_prob = last_output_keep_prob
        self.dropout_bits, self.dtype = dropout_bits, dtype
        self.weight_tied = weight_tied
        # flax's uniform(scale=0.1): U[0, 0.1)
        self.embedding = nn.Parameter(
            torch.rand((vocab_size, emb_size), generator=generator) * 0.1)
        width = emb_size
        for i in range(1, encoder_layers + 1):
            # the last layer of a tied LM outputs the embedding's width
            size = emb_size if weight_tied and i == encoder_layers \
                else hidden_size
            cls = GRU if cell_type == "gru" else LSTM
            self.add_module("rnn{}".format(i), cls(
                width, size, dtype=dtype, fused=fused_rnn,
                generator=generator))
            width = size
        self.num_layers = encoder_layers
        if weight_tied:
            self.softmax_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.softmax = Dense(width, vocab_size, torch.float32,
                                 resolve_initializer(None), generator)
        self.out_features = width

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None
                ) -> Dict[str, Any]:
        ids = x.long()
        h = F.embedding(ids, self.embedding).to(self.dtype)
        if train and self.emb_keep_prob < 1.0:
            h = h * word_dropout_scale(ids, self.vocab_size,
                                       self.emb_keep_prob, generator,
                                       self.dtype)
        for i in range(1, self.num_layers + 1):
            out_keep = self.last_output_keep_prob if i == self.num_layers \
                else self.output_keep_prob
            if train:
                h = dropout(h, self.input_keep_prob, generator,
                            self.dropout_bits, broadcast_dims=(1,))
            h, _ = self._modules["rnn{}".format(i)](h, lengths)
            if train:
                h = dropout(h, out_keep, generator, self.dropout_bits,
                            broadcast_dims=(1,))
        if self.weight_tied:
            weights, bias = self.embedding, self.softmax_bias
        else:
            weights, bias = self.softmax.weight, self.softmax.bias
        out: Dict[str, Any] = {"outputs": h, "src_length": lengths}
        if train and 0 < self.num_sampled < self.vocab_size:
            out.update({"weights": weights.float(), "bias": bias.float(),
                        "inputs": h.float(), "num_sampled": self.num_sampled,
                        "generator": generator})
        else:
            out["logits"] = F.linear(h.float(), weights.float(),
                                     bias.float())
        return out


class LMEncoderModule(nn.Module):

    def __init__(self, net: LMNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        return self.net(x, lengths, train, generator)


# the cells not ported yet, by a part of the ``core_cell`` name that
# selects them, with their placeholders (``parts/rnns/rnn._NotPorted``),
# which raise
_NOT_PORTED_CELLS = (("slstm", SLSTM), ("flstm", FLSTM),
                     ("layernorm", LayerNormLSTM),
                     ("layer_norm", LayerNormLSTM))


class LMEncoder(Encoder):
    """Config wrapper: the JAX package's schema (``lm_encoders.py:170-
    211``) less the keys that have no effect there or here (the
    classification head's, AWD's weight-drop knobs, the generation
    seeds, which come with ``data/lm``)."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "vocab_size": int,
            "emb_size": int,
            "encoder_layers": int,
            "encoder_use_skip_connections": bool,
            "core_cell": None,
            "core_cell_params": dict,
            "end_token": int,
            "batch_size": int,
            "use_cudnn_rnn": bool,
            "cudnn_rnn_type": None,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "encoder_dp_input_keep_prob": float,
            "encoder_dp_output_keep_prob": float,
            "encoder_last_output_keep_prob": float,
            "encoder_emb_keep_prob": float,
            "weight_tied": bool,
            "num_sampled": int,
            "lm_mode": bool,
        })

    def __init__(self, params, model, name="lm_encoder", mode="train"):
        super().__init__(params, model, name, mode)
        p = self._params
        if p["encoder_use_skip_connections"]:
            raise NotImplementedError("encoder_use_skip_connections is not "
                                      "ported (the JAX package ignores it)")
        if not p.get("lm_mode", True):
            raise NotImplementedError(
                "lm_mode: False (sentiment classification) is not ported "
                "yet: it comes with the LM transfer slice (ROADMAP.md)")
        extra = set(p["core_cell_params"]) - {"num_units"}
        if extra:
            raise NotImplementedError("core_cell_params {} are not ported "
                                      "yet".format(sorted(extra)))

    def cell_type(self) -> str:
        """"lstm" or "gru", from ``core_cell`` (a name, or a class whose
        name matches the reference's cells) and ``cudnn_rnn_type``, as the
        JAX package maps them; the cells not ported yet raise."""
        p = self._params
        core = p["core_cell"]
        name = (core if isinstance(core, str)
                else getattr(core, "__name__", "")) or ""
        name = name.lower()
        for part, cls in _NOT_PORTED_CELLS:
            if part in name:
                cls()
        if "gru" in name or "gru" in str(p["cudnn_rnn_type"] or "").lower():
            return "gru"
        return "lstm"

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> LMEncoderModule:
        """``in_features`` is unused: the inputs are ids."""
        p = self._params
        model_params = {} if self._model is None else self._model.params
        return LMEncoderModule(LMNet(
            vocab_size=p["vocab_size"],
            emb_size=p["emb_size"],
            encoder_layers=p["encoder_layers"],
            hidden_size=p["core_cell_params"].get("num_units", p["emb_size"]),
            weight_tied=p.get("weight_tied", False),
            cell_type=self.cell_type(),
            emb_keep_prob=p.get("encoder_emb_keep_prob", 1.0),
            input_keep_prob=p.get("encoder_dp_input_keep_prob", 1.0),
            output_keep_prob=p.get("encoder_dp_output_keep_prob", 1.0),
            last_output_keep_prob=p.get("encoder_last_output_keep_prob",
                                        1.0),
            num_sampled=p.get("num_sampled", 0),
            fused_rnn=bool(model_params.get("fused_rnn", False)),
            dropout_bits=model_params.get("dropout_bits", 32),
            dtype=self.compute_dtype,
            generator=generator))
