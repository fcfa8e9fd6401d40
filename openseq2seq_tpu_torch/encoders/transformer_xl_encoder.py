"""Transformer-XL language-model encoder (port of
``openseq2seq_tpu/encoders/transformer_xl_encoder.py``), driven by
``LSTMLM`` with the ``FakeDecoder`` like the LSTM LM encoder, and by
``apps/lm_rescorer.NeuralRescorer``.

Module and parameter names follow the flax module's (``embedding``,
``layer{i}_attn`` with the ``DenseGeneral`` kernels ``q``, ``k``, ``v``,
``r`` (D, H, Dh) and ``out`` (H, Dh, D) and the leaves ``u_bias``,
``w_bias``; ``layer{i}_ln1``, ``layer{i}_ff1``, ``layer{i}_ff2``,
``layer{i}_ln2``; ``softmax_bias``), so that ``convert.py`` maps one
onto the other. Kept from the JAX package:

  * relative attention, ``((q + u).k + (q + w).R[d]) / sqrt(Dh)`` with d
    the query-key distance: the sinusoid table of distances 0 .. K - 1
    taken in reverse, projected by ``r``, and aligned by the pad-reshape
    relative shift; keys after the query (the causal mask) and padded
    keys at -1e9; the scores summed in the compute type, the softmax in
    fp32, the weights back in the compute type. Plain matrix products,
    as in the JAX package, where no Pallas kernel computes them;
  * segment memory: ``mems``, one (B, M, D) tensor a layer, joined
    before the keys and values, the queries at offset M; with ``mem_len``
    the output carries the next segment's ``mems`` (the last ``mem_len``
    positions of each layer's input stream, cut from autograd) and
    ``mems_valid``, the stream's validity, which masks memory positions
    that were padding;
  * post-LN blocks (attention, residual, layer norm; ReLU FFN, residual,
    layer norm), flax's layer norm (fp32 statistics, eps 1e-6) and its
    dense layers' rounding (the product, then the bias);
  * dropout at the JAX sites, drawn in training from the generator passed
    to ``forward``: the embedding, the attention weights
    (``attention_dropout``), the attention's output, after the ReLU, after
    ``ff2``, and the last layer's output;
  * the tied softmax in fp32: the JAX package multiplies bf16 operands
    with fp32 accumulation into fp32 logits (``preferred_element_type``),
    then adds the fp32 bias. Here the operands are rounded to the compute
    type and multiplied as fp32 (``F.linear`` of the rounded values, TF32
    off): the same products of the same values, summed in fp32. The loss
    takes the logits through ``losses/sequence_loss.full_softmax_nll``'s
    row blocks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .conformer_encoder import DenseGeneral, LayerNorm
from .encoder import Encoder
from ..parts.dropout import dropout
from ..parts.transformer.common import Dense, rel_pos_embedding

NEG_INF = -1e9


class RelMultiHeadAttention(nn.Module):
    """Relative multi-head attention with optional segment memory
    (``transformer_xl_encoder.py:63-130``)."""

    def __init__(self, dim: int, num_heads: int, attention_keep: float,
                 dtype: torch.dtype, dropout_bits: int,
                 generator: torch.Generator):
        super().__init__()
        H, Dh = num_heads, dim // num_heads
        for name in ("q", "k", "v", "r"):
            self.add_module(name, DenseGeneral((dim,), (H, Dh), dtype,
                                               generator))
        self.u_bias = nn.Parameter(torch.zeros(H, Dh))
        self.w_bias = nn.Parameter(torch.zeros(H, Dh))
        self.out = DenseGeneral((H, Dh), (dim,), dtype, generator)
        self.num_heads, self.dtype = H, dtype
        self.attention_keep, self.dropout_bits = attention_keep, dropout_bits

    def forward(self, x: torch.Tensor, mems: Optional[torch.Tensor] = None,
                train: bool = False, pad_mask: Optional[torch.Tensor] = None,
                generator: torch.Generator = None) -> torch.Tensor:
        B, T, D = x.shape
        Dh = D // self.num_heads
        M = 0 if mems is None else mems.shape[1]
        ctx = x if mems is None else torch.cat([mems.to(x.dtype), x], 1)
        K = M + T
        q, k, v = self.q(x), self.k(ctx), self.v(ctx)
        u, w = self.u_bias.to(self.dtype), self.w_bias.to(self.dtype)
        table = torch.from_numpy(rel_pos_embedding(K, D)[::-1].copy())
        r = self.r(table.to(device=x.device, dtype=self.dtype))  # (K, H, Dh)
        ac = torch.einsum("bthd,bkhd->bhtk", q + u, k)
        # bd[t, j] = (q + w)[t].r[M + t - j]: the relative shift over the
        # reversed table; what wraps a row is masked as causal below
        pos = torch.einsum("bthd,khd->bhtk", q + w, r)
        bd = F.pad(pos, (1, 0)).reshape(B, -1, K + 1, T)[:, :, 1:] \
            .reshape(B, -1, T, K)
        logits = (ac + bd).float() * (1.0 / np.sqrt(Dh))
        dist = M + torch.arange(T, device=x.device)[:, None] - \
            torch.arange(K, device=x.device)[None, :]
        logits = torch.where(dist >= 0, logits, NEG_INF)
        if pad_mask is not None:
            logits = torch.where(pad_mask[:, None, None, :], logits,
                                 NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        if train:
            weights = dropout(weights, self.attention_keep, generator,
                              self.dropout_bits)
        out = torch.einsum("bhtk,bkhd->bthd", weights.to(self.dtype), v)
        return self.out(out)


class TransformerXLNet(nn.Module):
    """Embedding, ``num_layers`` relative-attention blocks and the tied
    softmax (``transformer_xl_encoder.py:133-222``)."""

    def __init__(self, vocab_size: int, num_layers: int, hidden_size: int,
                 num_heads: int, filter_size: int, dropout: float,
                 attention_dropout: float, mem_len: int, dtype: torch.dtype,
                 dropout_bits: int, generator: torch.Generator):
        super().__init__()
        D = hidden_size
        self.embedding = nn.Parameter(
            torch.randn((vocab_size, D), generator=generator) * D ** -0.5)
        for i in range(num_layers):
            self.add_module("layer{}_attn".format(i), RelMultiHeadAttention(
                D, num_heads, 1.0 - attention_dropout, dtype, dropout_bits,
                generator))
            self.add_module("layer{}_ln1".format(i), LayerNorm(D, dtype))
            self.add_module("layer{}_ff1".format(i),
                            Dense(D, filter_size, dtype, generator))
            self.add_module("layer{}_ff2".format(i),
                            Dense(filter_size, D, dtype, generator))
            self.add_module("layer{}_ln2".format(i), LayerNorm(D, dtype))
        self.softmax_bias = nn.Parameter(torch.zeros(vocab_size))
        self.num_layers, self.mem_len, self.dtype = num_layers, mem_len, \
            dtype
        self.keep, self.dropout_bits = 1.0 - dropout, dropout_bits
        self.out_features = D

    def _drop(self, x, train, generator):
        if not train:
            return x
        return dropout(x, self.keep, generator, self.dropout_bits)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None,
                mems: Optional[List[torch.Tensor]] = None,
                mems_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """``mems``: one (B, M, D) tensor a layer from the previous
        segment's output, with its ``mems_valid`` (B, M) (without it the
        memory is taken as valid throughout)."""
        B, T = x.shape
        table = self.embedding.to(self.dtype)
        h = self._drop(table[x.long()], train, generator)
        M = 0 if mems is None else mems[0].shape[1]
        cur_valid = torch.arange(T, device=x.device)[None, :] < \
            lengths[:, None]
        if M == 0:
            pad_mask = cur_valid
        else:
            mv = torch.ones((B, M), dtype=torch.bool, device=x.device) \
                if mems_valid is None else mems_valid.bool()
            pad_mask = torch.cat([mv, cur_valid], dim=1)
        new_mems = []
        for i in range(self.num_layers):
            layer_mem = None if mems is None else mems[i]
            if self.mem_len > 0:
                stream = h if layer_mem is None else \
                    torch.cat([layer_mem.to(h.dtype), h], dim=1)
                new_mems.append(stream[:, -self.mem_len:].detach())
            attn = self._modules["layer{}_attn".format(i)](
                h, mems=layer_mem, train=train, pad_mask=pad_mask,
                generator=generator)
            attn = self._drop(attn, train, generator)
            h = self._modules["layer{}_ln1".format(i)](h + attn)
            ff = torch.relu(self._modules["layer{}_ff1".format(i)](h))
            ff = self._drop(ff, train, generator)
            ff = self._drop(self._modules["layer{}_ff2".format(i)](ff),
                            train, generator)
            h = self._modules["layer{}_ln2".format(i)](h + ff)
        h = self._drop(h, train, generator)
        # the JAX product: operands rounded to the compute type, fp32 sums
        logits = F.linear(h.float(), table.float(), self.softmax_bias)
        out = {"outputs": h, "src_length": lengths, "logits": logits}
        if self.mem_len > 0:
            out["mems"] = new_mems
            out["mems_valid"] = (cur_valid if M == 0
                                 else pad_mask)[:, -self.mem_len:]
        return out


class TransformerXLModule(nn.Module):

    def __init__(self, net: TransformerXLNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        return self.net(x, lengths, train, generator,
                        mems=input_dict.get("mems"),
                        mems_valid=input_dict.get("mems_valid"))


class TransformerXLEncoder(Encoder):
    """Config wrapper, the JAX package's schema (the keys ``LSTMLM``
    fills in, ``lm_mode`` accepted as True)."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params())

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "vocab_size": int,
            "end_token": int,
            "batch_size": int,
            "lm_mode": bool,
            "num_layers": int,
            "hidden_size": int,
            "num_heads": int,
            "filter_size": int,
            "dropout": float,
            "attention_dropout": float,
            "mem_len": int,
        })

    def __init__(self, params, model, name="transformer_xl_encoder",
                 mode="train"):
        super().__init__(params, model, name, mode)
        if not self._params.get("lm_mode", True):
            raise ValueError("Transformer-XL is a language model: lm_mode "
                             "must be True")

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> TransformerXLModule:
        """``in_features`` is unused: the inputs are ids."""
        p = self._params
        model_params = {} if self._model is None else self._model.params
        return TransformerXLModule(TransformerXLNet(
            vocab_size=p["vocab_size"],
            num_layers=p.get("num_layers", 6),
            hidden_size=p.get("hidden_size", 512),
            num_heads=p.get("num_heads", 8),
            filter_size=p.get("filter_size", 2048),
            dropout=p.get("dropout", 0.1),
            attention_dropout=p.get("attention_dropout", 0.0),
            mem_len=p.get("mem_len", 0),
            dtype=self.compute_dtype,
            dropout_bits=model_params.get("dropout_bits", 32),
            generator=generator))
