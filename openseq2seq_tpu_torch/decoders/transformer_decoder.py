"""Transformer decoder (port of
``openseq2seq_tpu/decoders/transformer_decoder.py``).

Teacher-forced pass: the targets shifted right (``y[:, :-1]``) embedded
with the encoder's shared table, sinusoidal positions, N pre-norm
[causal self-attention, cross-attention, FFN] layers, a final layer norm
and fp32 logits from the same table. Outside training, and in infer mode
instead, :meth:`TransformerDecoderModule.decode` runs the beam search
(``ops/beam_search.py``) from the encoder output, one token per step:

  * the cross-attention K/V of every layer are projected once per
    sequence and tiled over the beams once; they never take part in the
    beam reorders (``transformer_decoder.py:322-330``);
  * the self-attention K and V of all layers live in two buffers, time
    first, (T_max, L, B*K, h, dh): V in the compute dtype, K in fp32
    holding the compute dtype's values (and the cross-attention K alike),
    which spares the fp32 score product an upcast per step and changes
    no value; a step writes its position and attends over the prefix
    ``[0, pos]``. That equals the
    JAX package's attention over the whole cache with the decode bias of
    ``beam_search.NEG_INF`` = -1e7 past ``pos``: those weights are
    exp(-1e7 - m) = 0 in fp32;
  * a beam reorder gathers only the written prefix, into a second buffer
    that then takes the first one's place;
  * the logits are fp32 from the table rounded to the compute dtype and
    upcast once per decode, which is exact: rounding them to bf16 would
    change which beams win.

Module names follow the flax module's (``self_attns_{i}``,
``cross_attns_{i}``, ``ffns_{i}``, ``sa_norms_{i}``, ``ca_norms_{i}``,
``ffn_norms_{i}``, ``out_norm``). The JAX package's TPU cache layouts
(``decode_cache``, ``decode_segments``, ``lazy_decode``) give identical
beams there and are accepted here as no-ops; the pipelined stack and
sequence parallelism are refused.

In training (``transformer_decoder.py:156-226``) the teacher-forced pass
runs alone, with no beam decode: dropout at ``layer_postprocess_dropout``
follows the embedding plus positions and each residual branch, the
attention dropout and the FFN's relu dropout run inside those layers, all
drawn from the step's generator, with the model's ``dropout_bits`` and
``fused_residual_dropout``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .decoder import Decoder
from ..parts.dropout import dropout
from ..ops.beam_search import beam_search, sequence_lengths_from_ids
from ..parts.transformer.attention import CrossAttention, SelfAttention
from ..parts.transformer.common import (TransformerNorm, embed_ids,
                                        get_decoder_self_attention_bias,
                                        position_encoding, project_logits)
from ..parts.transformer.ffn import FeedForwardNetwork

REFUSED = ("sequence_parallel", "num_pipeline_stages",
           "num_pipeline_microbatches")


class TransformerDecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], dtype: torch.dtype,
                 generator: torch.Generator, mode: str,
                 dropout_bits: int = 32, fused_dropout: bool = False):
        super().__init__()
        self.num_layers = L = p["num_hidden_layers"]
        self.hidden_size = d = p["hidden_size"]
        self.num_heads = p["num_heads"]
        self.vocab_size = p["tgt_vocab_size"]
        self.beam_size = p["beam_size"]
        self.alpha = p["alpha"]
        self.extra_decode_length = p["extra_decode_length"]
        self.eos_id = p["EOS_ID"]
        self.go_symbol = p.get("GO_SYMBOL", 2)
        self.dtype = dtype
        self.mode = mode
        self.postprocess_dropout = p["layer_postprocess_dropout"]
        self.dropout_bits = dropout_bits
        flash = p.get("use_flash_attention", False)
        attn = dict(attention_dropout=p["attention_dropout"],
                    dropout_bits=dropout_bits)
        norm = p.get("norm_params")
        for i in range(L):
            # the flash path masks k > q itself; the plain path takes the
            # causal bias
            self.add_module("self_attns_{}".format(i), SelfAttention(
                d, self.num_heads, dtype, generator, use_flash=flash,
                causal=True, **attn))
            self.add_module("cross_attns_{}".format(i), CrossAttention(
                d, self.num_heads, dtype, generator, use_flash=flash,
                **attn))
            self.add_module("ffns_{}".format(i), FeedForwardNetwork(
                d, p["filter_size"], dtype, generator,
                relu_dropout=p["relu_dropout"], dropout_bits=dropout_bits,
                fused_dropout=fused_dropout))
            for name in ("sa_norms", "ca_norms", "ffn_norms"):
                self.add_module("{}_{}".format(name, i),
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
        enc = input_dict["encoder_output"]
        if self.mode == "infer" or input_dict.get("target_tensors") is None:
            return self.decode(enc)
        table, memory = enc["embedding_table"], enc["outputs"]
        targets = input_dict["target_tensors"][0]
        dec_in = targets[:, :-1]
        T = dec_in.shape[1]
        x = embed_ids(table, dec_in, self.hidden_size, self.dtype) + \
            position_encoding(T, self.hidden_size, self.dtype,
                              dec_in.device)[None]
        x = self.drop(x, train, generator)
        self_bias = get_decoder_self_attention_bias(T, dec_in.device)
        for i in range(self.num_layers):
            h = self.layer("self_attns", i)(
                self.layer("sa_norms", i)(x), self_bias, train, generator)
            x = x + self.drop(h, train, generator)
            h = self.layer("cross_attns", i)(
                self.layer("ca_norms", i)(x), memory,
                enc["attention_bias"], train=train, generator=generator)
            x = x + self.drop(h, train, generator)
            h = self.layer("ffns", i)(self.layer("ffn_norms", i)(x), train,
                                      generator)
            x = x + self.drop(h, train, generator)
        logits = project_logits(table, self.out_norm(x), self.vocab_size)
        out = {"logits": logits, "targets": targets,
               "src_length": enc["src_length"]}
        if not train:
            out.update(self.decode(enc))
        return out

    def decode(self, enc: Dict[str, Any]) -> Dict[str, Any]:
        """Beam-search decode from the encoder output."""
        table, memory = enc["embedding_table"], enc["outputs"]
        B, S, d = memory.shape
        K, L, h = self.beam_size, self.num_layers, self.num_heads
        T = S + self.extra_decode_length
        dev = memory.device
        table_c = table.to(self.dtype)
        w_logits = table[:self.vocab_size].to(self.dtype).float()
        # K upcast to fp32 once (exact): ``_attend`` takes its scores in
        # fp32 and would upcast it at every step
        cross = []
        for i in range(L):
            kv = self.layer("cross_attns", i).precompute_kv(memory)
            cross.append({"k": kv["k"].float().repeat_interleave(K, 0),
                          "v": kv["v"].repeat_interleave(K, 0)})
        enc_bias = enc["attention_bias"].repeat_interleave(K, 0)
        pos_table = position_encoding(T, d, self.dtype, dev)
        shape = (T, L, B * K, h, d // h)
        caches = [(torch.zeros(shape, device=dev),          # k, fp32
                   torch.zeros(shape, dtype=self.dtype, device=dev))
                  for _ in range(2)]

        def step(ids: torch.Tensor, pos: int) -> torch.Tensor:
            k_cache, v_cache = caches[0]
            x = embed_ids(table_c, ids, d, self.dtype) + pos_table[pos]
            for i in range(L):
                x = x + self.layer("self_attns", i).decode_step(
                    self.layer("sa_norms", i)(x), k_cache[:, i],
                    v_cache[:, i], pos)
                x = x + self.layer("cross_attns", i)(
                    self.layer("ca_norms", i)(x), bias=enc_bias,
                    kv_cache=cross[i])
                x = x + self.layer("ffns", i)(self.layer("ffn_norms", i)(x))
            return self.out_norm(x)[:, 0].float() @ w_logits.t()

        def reorder(parents: torch.Tensor, pos: int) -> None:
            for src, dst in zip(*caches):
                torch.index_select(src[:pos + 1], 2, parents,
                                   out=dst[:pos + 1])
            caches.reverse()

        decoded, scores = beam_search(
            step, reorder, batch_size=B, beam_size=K,
            vocab_size=self.vocab_size, max_decode_length=T,
            eos_id=self.eos_id, alpha=self.alpha, bos_id=self.go_symbol,
            device=dev)
        top = decoded[:, 0, 1:]                       # strip BOS
        return {"outputs": [top, sequence_lengths_from_ids(top,
                                                           self.eos_id)],
                "scores": scores[:, 0], "beams": decoded}


class TransformerDecoder(Decoder):
    """Config wrapper; the schema is the JAX package's."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "EOS_ID": int,
            "layer_postprocess_dropout": float,
            "num_hidden_layers": int,
            "hidden_size": int,
            "num_heads": int,
            "attention_dropout": float,
            "relu_dropout": float,
            "filter_size": int,
            "batch_size": int,
            "tgt_vocab_size": int,
            "beam_size": int,
            "alpha": float,
            "extra_decode_length": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "GO_SYMBOL": int,
            "PAD_SYMBOL": int,
            "END_SYMBOL": int,
            "norm_params": dict,
            "use_flash_attention": bool,
            # TPU cache layouts of the JAX package, identical beams there:
            # no-ops here
            "lazy_decode": bool,
            "decode_cache": ["packed", "per_layer"],
            "decode_segments": int,
            "sequence_parallel": bool,
            "num_pipeline_stages": int,
            "num_pipeline_microbatches": int,
        })

    def __init__(self, params, model, name="decoder", mode="train"):
        super().__init__(params, model, name, mode)
        refused = [k for k in REFUSED if k in self._params]
        if refused:
            raise ValueError("TransformerDecoder options {} are not ported "
                             "yet".format(refused))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> TransformerDecoderModule:
        """``in_features`` is unused: the width is ``hidden_size``."""
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        model = self._model.params if self._model is not None else {}
        return TransformerDecoderModule(
            self._params, dtype, generator, self._mode,
            dropout_bits=model.get("dropout_bits", 32),
            fused_dropout=model.get("fused_residual_dropout", False))
