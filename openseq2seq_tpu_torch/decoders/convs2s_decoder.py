"""ConvS2S decoder (port of ``openseq2seq_tpu/decoders/convs2s_decoder.py``):
causal GLU conv blocks, each followed by dot-product attention over the
encoder (keys its outputs, values its ``attention_values`` where it has
them), then ``pre_out`` and the fp32 output projection.

What the JAX module computes, and so the port:

  * ``embedding`` and ``pos_embedding`` as the encoder's
    (``parts/convs2s.py``);
  * per block: the input (through ``conv{i}_res_proj`` where the widths
    differ) as the residual, dropout at ``1 - hidden_dropout_keep_prob``,
    the causal conv ``conv{i}`` (:class:`CausalConv1d`) to 2C, the GLU
    plus the residual, times sqrt(0.5); the query ``att_q{i}`` of that,
    combined with the target embedding, ``(q + e) sqrt(0.5)``, where the
    widths agree; scores and weights in fp32, -1e9 past each source
    length; the context scaled by ``s sqrt(1 / s)``, s the source length;
    ``att_out{i}`` of it added back, times sqrt(0.5);
  * ``pre_out``, dropout at ``1 - out_dropout_keep_prob``, then ``out`` to
    the vocabulary in fp32.

Teacher forcing reads the targets shifted right (``y[:, :-1]``, the
single shift of C22, the loss taking ``y[:, 1:]``). Outside training the
beam search (``ops/beam_search.py``) decodes from the encoder output,
``S + extra_decode_length`` tokens at most, each step re-running the
causal stack over the whole buffer of decoded ids (one shape for every
step, so that cuDNN tunes its convs once; a buffer growing by a position
a step made it tune them at every step), whose rows follow their beams,
as the JAX module does. Every layer is causal and row-wise, so only the
decoded position is projected to the vocabulary: the same function as
the JAX module's projection of every position, of which it keeps that
one.

``shared_embed`` has no effect (the decoder keeps its own tables), and
neither have ``pad_embeddings_2_eight``, ``att_layer_num``,
``PAD_SYMBOL``, ``END_SYMBOL``, ``conv_activation``,
``normalization_type``, ``scaling_factor`` and ``init_var``, as in the
JAX module. There is no weight normalization (C27).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import Decoder
from ..ops.beam_search import beam_search, sequence_lengths_from_ids
from ..parts.convs2s import glu_block, learned_embeddings, scaled
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import Dense

_NEG = -1e9


class ConvS2SDecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], enc_width: int, mode: str,
                 dtype: torch.dtype, generator: torch.Generator,
                 dropout_bits: int = 32):
        super().__init__()
        from ..encoders.tdnn_encoder import CausalConv1d
        E = p["tgt_emb_size"]
        self.vocab_size = p["tgt_vocab_size"]
        self.embedding, self.pos_embedding = learned_embeddings(
            self.vocab_size, p.get("max_input_length", 1024), E, generator)
        self.mode, self.dtype, self.dropout_bits = mode, dtype, dropout_bits
        self.embedding_keep = p["embedding_dropout_keep_prob"]
        self.hidden_keep = p["hidden_dropout_keep_prob"]
        self.out_keep = p["out_dropout_keep_prob"]
        self.beam_size, self.alpha = p["beam_size"], p["alpha"]
        self.extra_decode_length = p["extra_decode_length"]
        self.go_symbol, self.eos_id = p["GO_SYMBOL"], p["EOS_ID"]
        width = E
        self.num_blocks = len(p["conv_nchannels_kwidth"])
        for i, (ch, k) in enumerate(p["conv_nchannels_kwidth"], start=1):
            self.add_module("conv{}".format(i), CausalConv1d(
                width, 2 * ch, k, 1, 1, dtype, resolve_initializer(None),
                generator))
            self.add_module("conv{}_res_proj".format(i), Dense(
                width, ch, dtype, generator) if width != ch else None)
            self.add_module("att_q{}".format(i), Dense(ch, enc_width, dtype,
                                                       generator))
            self.add_module("att_out{}".format(i), Dense(enc_width, ch, dtype,
                                                         generator))
            width = ch
        self.pre_out = Dense(width, p["out_emb_size"], dtype, generator)
        self.out = Dense(p["out_emb_size"], self.vocab_size, torch.float32,
                         generator)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return (F.embedding(ids.long(), self.embedding) +
                self.pos_embedding[None, :ids.shape[1]]).to(self.dtype)

    def stack(self, dec_in: torch.Tensor, keys: torch.Tensor,
              values: torch.Tensor, enc_mask: torch.Tensor, train: bool,
              generator: torch.Generator) -> torch.Tensor:
        """Decoder inputs (B, T, E) -> features (B, T, C_last); ``keys``
        and ``values`` fp32."""
        x = emb = dec_in
        # the context's source-length scaling, s sqrt(1 / s)
        s = enc_mask.sum(-1, keepdim=True)[:, :, None].float()
        scale = s * torch.sqrt(1.0 / torch.clamp(s, min=1.0))
        for i in range(1, self.num_blocks + 1):
            x = glu_block(x, getattr(self, "conv{}".format(i)),
                          getattr(self, "conv{}_res_proj".format(i)),
                          self.hidden_keep, train, generator,
                          self.dropout_bits)
            q = getattr(self, "att_q{}".format(i))(x)
            if emb.shape[-1] == q.shape[-1]:
                q = scaled(q + emb)
            scores = torch.einsum("btd,bsd->bts", q.float(), keys)
            scores = scores.masked_fill(~enc_mask[:, None, :], _NEG)
            ctx = torch.einsum("bts,bsd->btd", torch.softmax(scores, -1),
                               values) * scale
            ctx = getattr(self, "att_out{}".format(i))(ctx.to(self.dtype))
            x = scaled(x + ctx)
        return x

    def project(self, x: torch.Tensor, train: bool,
                generator: torch.Generator) -> torch.Tensor:
        h = self.pre_out(x)
        if train:
            h = dropout(h, self.out_keep, generator, self.dropout_bits)
        return self.out(h.float())

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        enc = input_dict["encoder_output"]
        keys = enc["outputs"].float()
        values = enc.get("attention_values", enc["outputs"]).float()
        mem_len = enc["src_length"]
        S = keys.shape[1]
        enc_mask = torch.arange(S, device=keys.device)[None, :] < \
            mem_len[:, None]
        out: Dict[str, Any] = {"src_length": mem_len}
        targets = input_dict.get("target_tensors")
        if targets is not None and self.mode != "infer":
            y = targets[0]
            dec_in = self.embed(y[:, :-1])
            if train:
                dec_in = dropout(dec_in, self.embedding_keep, generator,
                                 self.dropout_bits)
            feats = self.stack(dec_in, keys, values, enc_mask, train,
                               generator)
            out["logits"] = self.project(feats, train, generator)
            out["targets"] = y
        if not train:
            # the train model's module also runs the trainer's evals
            out.update(self.decode(keys, values, enc_mask))
        return out

    def decode(self, keys: torch.Tensor, values: torch.Tensor,
               enc_mask: torch.Tensor) -> Dict[str, Any]:
        """Beam search over the re-run causal stack."""
        B, S = enc_mask.shape
        K = self.beam_size
        T = S + self.extra_decode_length
        keys, values, enc_mask = (t.repeat_interleave(K, 0)
                                  for t in (keys, values, enc_mask))
        buf = [torch.full((B * K, T), self.go_symbol, dtype=torch.long,
                          device=keys.device)]

        def step(ids: torch.Tensor, pos: int) -> torch.Tensor:
            buf[0][:, pos] = ids[:, 0]
            feats = self.stack(self.embed(buf[0]), keys, values, enc_mask,
                               False, None)
            return self.project(feats[:, pos], False, None)

        def reorder(parents: torch.Tensor, pos: int) -> None:
            buf[0] = buf[0].index_select(0, parents)

        decoded, scores = beam_search(
            step, reorder, batch_size=B, beam_size=K,
            vocab_size=self.vocab_size, max_decode_length=T,
            eos_id=self.eos_id, alpha=self.alpha, bos_id=self.go_symbol,
            device=keys.device)
        top = decoded[:, 0, 1:]
        return {"outputs": [top, sequence_lengths_from_ids(top,
                                                           self.eos_id)],
                "scores": scores[:, 0]}


class ConvS2SDecoder(Decoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "batch_size": int,
            "tgt_emb_size": int,
            "tgt_vocab_size": int,
            "shared_embed": bool,
            "embedding_dropout_keep_prob": float,
            "conv_nchannels_kwidth": list,
            "hidden_dropout_keep_prob": float,
            "out_dropout_keep_prob": float,
            "beam_size": int,
            "alpha": float,
            "extra_decode_length": int,
            "EOS_ID": int,
            "GO_SYMBOL": int,
            "out_emb_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "pad_embeddings_2_eight": bool,
            "att_layer_num": int,
            "max_input_length": int,
            "PAD_SYMBOL": int,
            "END_SYMBOL": int,
            "conv_activation": None,
            "normalization_type": str,
            "scaling_factor": float,
            "init_var": None,
        })

    def make_module(self, in_features: int, generator: torch.Generator
                    ) -> ConvS2SDecoderModule:
        """``in_features`` is the encoder's output width."""
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        model = self._model.params if self._model is not None else {}
        return ConvS2SDecoderModule(self._params, in_features, self._mode,
                                    dtype, generator,
                                    model.get("dropout_bits", 32))
