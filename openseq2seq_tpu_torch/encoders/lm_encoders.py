"""Language-model encoder (port of
``openseq2seq_tpu/encoders/lm_encoders.py``).

An embedding, a stack of unidirectional recurrent layers
(``parts/rnns/rnn.py``) and, in LM mode, the vocabulary projection: the
encoder itself produces the logits, and the decoder is the pass-through
``FakeDecoder``. Module and parameter names follow the flax module's
(``embedding``, ``rnn{i}``, ``softmax`` or, with the weights tied to the
embedding, ``softmax_bias``; ``fc_hidden`` and ``classifier`` in
classification) so that ``convert.py`` maps one onto the other.

The cell is selected from ``core_cell`` (a name, or a class whose name
matches the reference's) and ``cudnn_rnn_type`` as the JAX package
selects it: ``slstm`` (``BasicSLSTMCell``), ``flstm`` (``FLSTMCell``,
with ``core_cell_params`` ``fact_size``, by default half the width, and
``num_proj``), ``layernorm``/``layer_norm`` (``WeightDropLayerNorm
BasicLSTMCell``, with the encoder key ``recurrent_weight_keep_prob``),
``gru``, else the LSTM.

In training, dropout draws from the ``torch.Generator`` passed to
``forward`` at the JAX module's sites: the embedding's whole-word dropout
(one keep draw per vocabulary entry, ``parts/dropout.word_dropout_scale``),
then before each layer its input dropout and after it its output dropout
(the last layer's own keep probability), each one (B, 1, D) mask shared
over time (``parts/dropout.dropout`` with ``broadcast_dims=(1,)``); the
layer-norm LSTM's DropConnect mask on W_h comes from the same generator.

LM mode: in training with ``0 < num_sampled < vocab_size`` the module
emits the sampled-softmax bundle and no (B, T, V) logits: the softmax
``weights`` (V, E) and ``bias`` in fp32, the last layer's outputs as fp32
``inputs``, ``num_sampled`` and the step's ``generator``, which draws the
candidates in ``losses/sequence_loss.py`` (the JAX module hands its loss
a ``sample_rng`` from the same stream). Otherwise it emits fp32 logits,
computed in fp32 from fp32 weights whatever the compute type.

Classification (``lm_mode: False``, the transfer recipes): the last valid
output of each row, with ``use_cell_state`` the last layer's final c
beside it, through an optional ReLU layer of ``fc_dim`` in the compute
type, then the fp32 ``classifier``: (B, num_classes) logits.

The model key ``fused_rnn`` reaches the LSTM and GRU layers explicitly:
their recurrences then run on kernels B3 and B4, forward and backward,
where the JAX package would run its Pallas kernels. Skip connections,
which the JAX module ignores, are refused.
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
    in; in LM mode the last layer's outputs, the lengths and the logits
    or the sampled-softmax bundle out, in classification the logits
    (B, num_classes), the head's input as ``outputs`` and the lengths."""

    def __init__(self, vocab_size: int, emb_size: int, encoder_layers: int,
                 hidden_size: int, weight_tied: bool, cell_type: str,
                 emb_keep_prob: float, input_keep_prob: float,
                 output_keep_prob: float, last_output_keep_prob: float,
                 num_sampled: int, fused_rnn: bool, dropout_bits: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 lm_mode: bool = True, fc_dim: int = 0, num_classes: int = 2,
                 use_cell_state: bool = False, fact_size: int = 0,
                 num_proj: int = 0,
                 recurrent_weight_keep_prob: float = 1.0):
        super().__init__()
        self.vocab_size, self.num_sampled = vocab_size, num_sampled
        self.emb_keep_prob, self.input_keep_prob = emb_keep_prob, \
            input_keep_prob
        self.output_keep_prob = output_keep_prob
        self.last_output_keep_prob = last_output_keep_prob
        self.dropout_bits, self.dtype = dropout_bits, dtype
        self.weight_tied, self.lm_mode = weight_tied, lm_mode
        self.cell_type, self.use_cell_state = cell_type, use_cell_state
        # flax's uniform(scale=0.1): U[0, 0.1)
        self.embedding = nn.Parameter(
            torch.rand((vocab_size, emb_size), generator=generator) * 0.1)
        width = emb_size
        for i in range(1, encoder_layers + 1):
            # the last layer of a tied LM outputs the embedding's width
            size = emb_size if lm_mode and weight_tied and \
                i == encoder_layers else hidden_size
            if cell_type == "slstm":
                cell, out = SLSTM(width, size, dtype=dtype,
                                  generator=generator), size
            elif cell_type == "flstm":
                cell = FLSTM(width, size, fact_size or size // 2, num_proj,
                             dtype=dtype, generator=generator)
                out = num_proj or size
            elif cell_type == "layernorm_lstm":
                cell, out = LayerNormLSTM(
                    width, size,
                    recurrent_weight_keep_prob=recurrent_weight_keep_prob,
                    dtype=dtype, generator=generator), size
            else:
                cls = GRU if cell_type == "gru" else LSTM
                cell, out = cls(width, size, dtype=dtype, fused=fused_rnn,
                                generator=generator), size
            self.add_module("rnn{}".format(i), cell)
            width, last_size = out, size
        self.num_layers = encoder_layers
        self.out_features = width
        if not lm_mode:
            feat = width + (last_size if use_cell_state else 0)
            if fc_dim > 0:
                self.fc_hidden = Dense(feat, fc_dim, dtype,
                                       resolve_initializer(None), generator)
                feat = fc_dim
            self.classifier = Dense(feat, num_classes, torch.float32,
                                    resolve_initializer(None), generator)
            self.out_features = feat
        elif weight_tied:
            self.softmax_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.softmax = Dense(width, vocab_size, torch.float32,
                                 resolve_initializer(None), generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None
                ) -> Dict[str, Any]:
        ids = x.long()
        h = F.embedding(ids, self.embedding).to(self.dtype)
        if train and self.emb_keep_prob < 1.0:
            h = h * word_dropout_scale(ids, self.vocab_size,
                                       self.emb_keep_prob, generator,
                                       self.dtype)
        state = None
        for i in range(1, self.num_layers + 1):
            out_keep = self.last_output_keep_prob if i == self.num_layers \
                else self.output_keep_prob
            if train:
                h = dropout(h, self.input_keep_prob, generator,
                            self.dropout_bits, broadcast_dims=(1,))
            cell = self._modules["rnn{}".format(i)]
            if self.cell_type == "layernorm_lstm":
                h, state = cell(h, lengths, train=train,
                                generator=generator)
            else:
                h, state = cell(h, lengths)
            if train:
                h = dropout(h, out_keep, generator, self.dropout_bits,
                            broadcast_dims=(1,))
        if not self.lm_mode:
            return self._classify(h, lengths, state)
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

    def _classify(self, h, lengths, state) -> Dict[str, Any]:
        """The head: the last valid output of each row (and the last
        layer's final c), the optional ReLU layer, the fp32 classifier."""
        idx = (lengths.long() - 1).clamp(0, h.shape[1] - 1)
        feat = h[torch.arange(h.shape[0], device=h.device), idx]
        if self.use_cell_state:
            # a GRU's state is its h, which the JAX module takes as c too
            c = state if self.cell_type == "gru" else state[1]
            feat = torch.cat([feat, c.to(feat.dtype)], dim=-1)
        if hasattr(self, "fc_hidden"):
            feat = torch.relu(self.fc_hidden(feat))
        return {"logits": self.classifier(feat.float()), "outputs": feat,
                "src_length": lengths}


class LMEncoderModule(nn.Module):

    def __init__(self, net: LMNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        return self.net(x, lengths, train, generator)


class LMEncoder(Encoder):
    """Config wrapper: the JAX package's schema (``lm_encoders.py:170-
    211``) less the keys that have no effect there or here (AWD's other
    weight-drop knobs, variational recurrence, scheduled sampling).
    ``fc_use_bias`` is accepted as the transfer recipes set it, True: the
    classifier has a bias, as in the JAX package, and False is refused.
    ``seed_tokens`` is ``LSTMLM.generate``'s default prompt."""

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
            "fc_dim": int,
            "use_cell_state": bool,
            "num_classes": int,
            "fc_use_bias": bool,
            "recurrent_weight_keep_prob": float,
            "seed_tokens": None,
        })

    def __init__(self, params, model, name="lm_encoder", mode="train"):
        super().__init__(params, model, name, mode)
        p = self._params
        if p["encoder_use_skip_connections"]:
            raise NotImplementedError("encoder_use_skip_connections is not "
                                      "ported (the JAX package ignores it)")
        if not p.get("fc_use_bias", True):
            raise ValueError("fc_use_bias: False has no effect in the JAX "
                             "package (its classifier has a bias) and is "
                             "refused")
        extra = set(p["core_cell_params"]) - {"num_units", "fact_size",
                                              "num_proj"}
        if extra:
            raise ValueError("core_cell_params {} have no effect".format(
                sorted(extra)))

    def cell_type(self) -> str:
        """"slstm", "flstm", "layernorm_lstm", "gru" or "lstm", from
        ``core_cell`` (a name, or a class whose name matches the
        reference's cells) and ``cudnn_rnn_type``, as the JAX package
        maps them."""
        p = self._params
        core = p["core_cell"]
        name = ((core if isinstance(core, str)
                 else getattr(core, "__name__", "")) or "").lower()
        if "slstm" in name:
            return "slstm"
        if "flstm" in name:
            return "flstm"
        if "layernorm" in name or "layer_norm" in name:
            return "layernorm_lstm"
        if "gru" in name or "gru" in str(p["cudnn_rnn_type"] or "").lower():
            return "gru"
        return "lstm"

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> LMEncoderModule:
        """``in_features`` is unused: the inputs are ids."""
        p = self._params
        model_params = {} if self._model is None else self._model.params
        core = p["core_cell_params"]
        return LMEncoderModule(LMNet(
            vocab_size=p["vocab_size"],
            emb_size=p["emb_size"],
            encoder_layers=p["encoder_layers"],
            hidden_size=core.get("num_units", p["emb_size"]),
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
            generator=generator,
            lm_mode=p.get("lm_mode", True),
            fc_dim=p.get("fc_dim", 0),
            num_classes=p.get("num_classes", 2),
            use_cell_state=p.get("use_cell_state", False),
            fact_size=core.get("fact_size", 0),
            num_proj=core.get("num_proj", 0),
            recurrent_weight_keep_prob=p.get("recurrent_weight_keep_prob",
                                             1.0)))
