"""Transformer encoder (port of
``openseq2seq_tpu/encoders/transformer_encoder.py``).

Shared embedding plus sinusoidal positions, N pre-norm [self-attention,
FFN] layers with residual sums, a final layer norm. The output dict
carries the shared embedding table so that the decoder embeds targets
and projects logits with the same parameter, and the (B, 1, 1, T)
padding bias for the cross-attention. Module names follow the flax
module's (``embedding``, ``self_attns_{i}``, ``ffns_{i}``,
``sa_norms_{i}``, ``ffn_norms_{i}``, ``out_norm``) so that
``convert.py`` maps one onto the other by name.

Same schema as the JAX package's. ``remove_padding`` and
``pad_embeddings_2_eight`` are honoured as there (the first has no
effect there either); ``sequence_parallel``, the mixture-of-experts FFN
(``moe_*``) and the pipelined stack (``num_pipeline_*``) are refused.

In training (``encoder.py:119-153``) dropout at
``layer_postprocess_dropout`` follows the embedding plus positions and
each residual branch, the attention dropout and the FFN's relu dropout
run inside those layers, all drawn from the step's generator; the
model's ``dropout_bits`` and ``fused_residual_dropout`` apply.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .encoder import Encoder
from ..parts.dropout import dropout
from ..parts.transformer.attention import SelfAttention
from ..parts.transformer.common import (SharedEmbedding, TransformerNorm,
                                        get_padding_bias, position_encoding)
from ..parts.transformer.ffn import FeedForwardNetwork

REFUSED = ("sequence_parallel", "moe_num_experts", "moe_loss_weight",
           "num_pipeline_stages", "num_pipeline_microbatches")


class TransformerEncoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], dtype: torch.dtype,
                 generator: torch.Generator, dropout_bits: int = 32,
                 fused_dropout: bool = False):
        super().__init__()
        self.num_layers = p["encoder_layers"]
        self.hidden_size = d = p["hidden_size"]
        self.out_features = d
        self.dtype = dtype
        self.postprocess_dropout = p["layer_postprocess_dropout"]
        self.dropout_bits = dropout_bits
        self.embedding = SharedEmbedding(
            p["src_vocab_size"], d, p.get("pad_embeddings_2_eight", False),
            dtype, generator)
        norm = p.get("norm_params")
        for i in range(self.num_layers):
            self.add_module("self_attns_{}".format(i), SelfAttention(
                d, p["num_heads"], dtype, generator,
                use_flash=p.get("use_flash_attention", False),
                attention_dropout=p["attention_dropout"],
                dropout_bits=dropout_bits))
            self.add_module("ffns_{}".format(i), FeedForwardNetwork(
                d, p["filter_size"], dtype, generator,
                relu_dropout=p["relu_dropout"], dropout_bits=dropout_bits,
                fused_dropout=fused_dropout))
            self.add_module("sa_norms_{}".format(i), TransformerNorm(d, norm))
            self.add_module("ffn_norms_{}".format(i),
                            TransformerNorm(d, norm))
        self.out_norm = TransformerNorm(d, norm)

    def layer(self, name: str, i: int) -> nn.Module:
        return getattr(self, "{}_{}".format(name, i))

    def drop(self, x: torch.Tensor, train: bool,
             generator: torch.Generator) -> torch.Tensor:
        """The post-process dropout of a training call."""
        if not train:
            return x
        return dropout(x, 1.0 - self.postprocess_dropout, generator,
                       self.dropout_bits)

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        ids, lengths = input_dict["source_tensors"][:2]
        bias = get_padding_bias(ids)                       # (B,1,1,T) fp32
        x = self.embedding(ids) + position_encoding(
            ids.shape[1], self.hidden_size, self.dtype, ids.device)[None]
        x = self.drop(x, train, generator)
        for i in range(self.num_layers):
            h = self.layer("self_attns", i)(
                self.layer("sa_norms", i)(x), bias, train, generator)
            x = x + self.drop(h, train, generator)
            h = self.layer("ffns", i)(self.layer("ffn_norms", i)(x), train,
                                      generator)
            x = x + self.drop(h, train, generator)
        return {"outputs": self.out_norm(x),
                "inputs": ids,
                "src_length": lengths,
                "attention_bias": bias,
                "embedding_table": self.embedding.embedding}


class TransformerEncoder(Encoder):
    """Config wrapper; the schema is the JAX package's."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "encoder_layers": int,
            "hidden_size": int,
            "num_heads": int,
            "attention_dropout": float,
            "filter_size": int,
            "src_vocab_size": int,
            "relu_dropout": float,
            "layer_postprocess_dropout": float,
            "remove_padding": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "pad_embeddings_2_eight": bool,
            "norm_params": dict,
            "sequence_parallel": bool,
            "moe_num_experts": int,
            "moe_loss_weight": float,
            "use_flash_attention": bool,
            "num_pipeline_stages": int,
            "num_pipeline_microbatches": int,
        })

    def __init__(self, params, model, name="encoder", mode="train"):
        super().__init__(params, model, name, mode)
        refused = [k for k in REFUSED if k in self._params]
        if refused:
            raise ValueError("TransformerEncoder options {} are not ported "
                             "yet".format(refused))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> TransformerEncoderModule:
        """``in_features`` is unused: the encoder embeds token ids."""
        model = self._model.params if self._model is not None else {}
        return TransformerEncoderModule(
            self._params, self.compute_dtype, generator,
            dropout_bits=model.get("dropout_bits", 32),
            fused_dropout=model.get("fused_residual_dropout", False))
