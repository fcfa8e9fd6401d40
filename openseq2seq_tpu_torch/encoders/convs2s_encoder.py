"""ConvS2S encoder (port of ``openseq2seq_tpu/encoders/convs2s_encoder.py``):
token plus learned position embeddings, then GLU conv blocks with
residual connections scaled by sqrt(0.5).

What the JAX module computes, and so the port:

  * ``embedding`` (V, E) and ``pos_embedding`` (``max_input_length``, E),
    fp32 leaves drawn from N(0, 0.1^2), gathered and summed in fp32, then
    rounded to the compute type; dropout at ``1 -
    embedding_dropout_keep_prob``; zeros past each length;
  * per block (``parts/convs2s.glu_block``): dropout at ``1 -
    hidden_dropout_keep_prob`` before the conv ``conv{i}`` (SAME, to 2C),
    the GLU ``a * sigmoid(b)``, plus the block's input (through the dense
    ``conv{i}_res_proj`` where the widths differ), times sqrt(0.5); zeros
    past each length;
  * the outputs are the attention keys; the attention values are
    ``(outputs + e) * sqrt(0.5)``, e the embedded input (through the dense
    ``emb_proj`` where the widths differ).

There is no weight normalization, as in the JAX package (C27: its
docstring records the reference's weight-normalized layers replaced by
plain ones). Dropout draws from the step's generator with the model's
``dropout_bits``. ``pad_embeddings_2_eight``, ``att_layer_num``,
``PAD_SYMBOL``, ``conv_activation``, ``normalization_type``,
``scaling_factor`` and ``init_var`` are accepted with no effect, as in
the JAX module.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from ..parts.convs2s import glu_block, learned_embeddings, scaled
from ..parts.dropout import dropout
from ..parts.transformer.common import Dense

class ConvS2SEncoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], dtype: torch.dtype,
                 generator: torch.Generator, dropout_bits: int = 32):
        super().__init__()
        from .tdnn_encoder import SameConv1d
        from ..parts.initializers import resolve_initializer
        E = p["src_emb_size"]
        self.embedding, self.pos_embedding = learned_embeddings(
            p["src_vocab_size"], p.get("max_input_length", 1024), E,
            generator)
        self.dtype, self.dropout_bits = dtype, dropout_bits
        self.embedding_keep = p["embedding_dropout_keep_prob"]
        self.hidden_keep = p["hidden_dropout_keep_prob"]
        width = E
        self.num_blocks = len(p["conv_nchannels_kwidth"])
        for i, (ch, k) in enumerate(p["conv_nchannels_kwidth"], start=1):
            self.add_module("conv{}".format(i), SameConv1d(
                width, 2 * ch, k, 1, 1, dtype, resolve_initializer(None),
                generator))
            self.add_module("conv{}_res_proj".format(i), Dense(
                width, ch, dtype, generator) if width != ch else None)
            width = ch
        self.emb_proj = Dense(E, width, dtype, generator) \
            if width != E else None
        self.out_features = width

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        ids, lengths = input_dict["source_tensors"][:2]
        T = ids.shape[1]
        x = (F.embedding(ids.long(), self.embedding) +
             self.pos_embedding[None, :T]).to(self.dtype)
        if train:
            x = dropout(x, self.embedding_keep, generator, self.dropout_bits)
        mask = (torch.arange(T, device=ids.device)[None, :] <
                lengths[:, None])[:, :, None].to(x.dtype)
        x = x * mask
        emb = x
        for i in range(1, self.num_blocks + 1):
            x = glu_block(x, getattr(self, "conv{}".format(i)),
                          getattr(self, "conv{}_res_proj".format(i)),
                          self.hidden_keep, train, generator,
                          self.dropout_bits) * mask
        e = emb if self.emb_proj is None else self.emb_proj(emb)
        return {"outputs": x, "attention_values": scaled(x + e),
                "src_length": lengths}


class ConvS2SEncoder(Encoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "src_emb_size": int,
            "src_vocab_size": int,
            "pad_embeddings_2_eight": bool,
            "conv_nchannels_kwidth": list,
            "embedding_dropout_keep_prob": float,
            "hidden_dropout_keep_prob": float,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "att_layer_num": int,
            "max_input_length": int,
            "PAD_SYMBOL": int,
            "conv_activation": None,
            "normalization_type": str,
            "scaling_factor": float,
            "init_var": None,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> ConvS2SEncoderModule:
        """``in_features`` is unused: the input is token ids."""
        model = self._model.params if self._model is not None else {}
        return ConvS2SEncoderModule(self._params, self.compute_dtype,
                                    generator, model.get("dropout_bits", 32))
