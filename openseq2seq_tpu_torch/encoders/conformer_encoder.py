"""Conformer encoder (port of ``openseq2seq_tpu/encoders/conformer_encoder.py``).

A front end of two 3x3 stride-2 SAME 2-D convs over (time, frequency)
with swish (4x fewer frames), a projection to the model width, then
Conformer blocks: a half-step FFN, relative-position self-attention, the
convolution module, a second half-step FFN and a layer norm. Module and
parameter names follow the flax module's (``sub_conv1``, ``sub_proj``,
``block{i}`` with ``ffn1``, ``attn_ln``, ``attn`` (``q``, ``k``, ``v``,
``r``, ``out``, ``u_bias``, ``w_bias``), ``conv`` (its ten explicit
leaves), ``ffn2``, ``final_ln``) so that ``convert.py`` maps one onto the
other: the attention's projections keep flax's ``DenseGeneral`` kernels
((D, H, Dh), and (H, Dh, D) for ``out``) as they are, and so do the
conv module's leaves.

Kept from the JAX package:
  * the front end's SAME padding is XLA's (``tdnn_encoder.same_padding``),
    nothing is masked between its convs, lengths go to ceil(len / 2)
    twice, and (B, T, F, C) is flattened with C fastest;
  * the blocks and their residual adds run in the compute dtype from fp32
    params; layer norms take fp32 statistics, eps 1e-6;
  * the attention scores Transformer-XL style, (q+u).k + (q+w).R[i-j],
    with the reversed table and the pad-reshape relative shift, padded
    keys at -1e9, fp32 softmax. With ``flash_attention`` the position
    term is folded into the q.k product and the attention runs on kernel
    B5 (``ops/flash_relpos.py``); K_r is the ``r`` kernel in the compute
    dtype (the JAX package applies ``r`` to an identity for that, which
    is exact);
  * the conv module's unfused chain runs in the compute dtype; with
    ``fused_conv_module`` it runs on kernel B6 (``ops/conformer_conv.py``)
    at that kernel's precision.

On a CPU tensor both kernels run their plain versions, forward and
backward. In training, dropout (``parts/dropout.py``, with the model's
``dropout_bits``) draws from the ``torch.Generator`` passed to the forward,
at the JAX module's sites: after ``sub_proj``; in each FFN after the swish
and after ``ff2``; on the attention's output; on the attention weights on
the plain path only (the flash kernel has none, as in the JAX package);
and on the conv module's output, fused or not. ``conv_norm: batch_norm``
is refused: neither TPU kernel computes it and Conformer-M does not use
it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ds2_encoder import SameConv2d
from .encoder import Encoder
from .tdnn_encoder import _mask_time, _out_length, same_padding
from ..ops import conformer_conv, flash_relpos
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import Dense, rel_pos_embedding

NEG_INF = -1e9


def _layer_norm(x: torch.Tensor, weight, bias, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: fp32 statistics, eps 1e-6, out in dtype."""
    return F.layer_norm(x.float(), weight.shape, weight.float(),
                        bias.float(), 1e-6).to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` as a module of its own (``attn_ln``,
    ``final_ln``)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias, self.dtype)


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` without a bias, its ``kernel`` in flax's
    layout: ``in_shape + out_shape``, contracting x's last
    ``len(in_shape)`` axes, computed in ``dtype``; lecun-normal over the
    input fan."""

    def __init__(self, in_shape, out_shape, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        n_in, n_out = int(np.prod(in_shape)), int(np.prod(out_shape))
        w = torch.empty(n_out, n_in)
        resolve_initializer(None)(w, generator)
        self.kernel = nn.Parameter(w.t().reshape(*in_shape, *out_shape)
                                   .contiguous())
        self.in_dims, self.out_shape = len(in_shape), tuple(out_shape)
        self.n_in = n_in
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - self.in_dims]
        y = x.reshape(*lead, self.n_in).to(self.dtype) @ \
            self.kernel.to(self.dtype).reshape(self.n_in, -1)
        return y.reshape(*lead, *self.out_shape)


class _Dropout:
    """The dropout of one module in training: ``keep_prob`` with the
    model's ``dropout_bits``; the identity outside training."""

    def __init__(self, keep_prob: float, dropout_bits: int):
        self.keep_prob, self.dropout_bits = keep_prob, dropout_bits

    def __call__(self, x, train: bool, generator):
        if not train:
            return x
        return dropout(x, self.keep_prob, generator, self.dropout_bits)


class RelPosSelfAttention(nn.Module):
    """Bidirectional multi-head self-attention with relative positions
    (``conformer_encoder.py:79-166``); dropout of the attention weights
    in training on the plain path only."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 use_flash: bool, generator: torch.Generator,
                 drop: _Dropout = _Dropout(1.0, 32)):
        super().__init__()
        H, Dh = num_heads, dim // num_heads
        for name in ("q", "k", "v"):
            self.add_module(name, DenseGeneral((dim,), (H, Dh), dtype,
                                               generator))
        self.u_bias = nn.Parameter(torch.zeros(H, Dh))
        self.w_bias = nn.Parameter(torch.zeros(H, Dh))
        self.r = DenseGeneral((dim,), (H, Dh), dtype, generator)
        self.out = DenseGeneral((H, Dh), (dim,), dtype, generator)
        self.num_heads, self.dtype, self.use_flash = H, dtype, use_flash
        self.drop = drop

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                pad_mask: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        B, T, D = x.shape
        Dh = D // self.num_heads
        q, k, v = self.q(x), self.k(x), self.v(x)          # (B, T, H, Dh)
        u, w = self.u_bias.to(self.dtype), self.w_bias.to(self.dtype)
        scale = 1.0 / np.sqrt(Dh)
        if self.use_flash:
            ctx = flash_relpos.rel_flash_attention(
                q + u, q + w, k, v, self.r.kernel.to(self.dtype), lengths,
                scale)
            return self.out(ctx)
        table = torch.from_numpy(rel_pos_embedding(2 * T - 1, D)[::-1].copy())
        r = self.r(table.to(device=x.device, dtype=self.dtype))
        ac = torch.einsum("bthd,bkhd->bhtk", q + u, k)
        pos_score = torch.einsum("bthd,rhd->bhtr", q + w, r)
        # the relative shift over the reversed table: bd[t, j] reads
        # pos_score[t, j + T - 1 - t]
        ps = F.pad(pos_score, (1, 0)).reshape(B, -1, 2 * T, T)[:, :, 1:]
        bd = ps.reshape(B, -1, T, 2 * T - 1)[..., :T]
        logits = (ac + bd).float() * scale
        logits = torch.where(pad_mask[:, None, None, :], logits, NEG_INF)
        weights = self.drop(torch.softmax(logits, dim=-1), train, generator)
        weights = weights.to(self.dtype)
        return self.out(torch.einsum("bhtk,bkhd->bthd", weights, v))


class _FFN(nn.Module):
    """LN -> expand -> swish -> dropout -> project -> dropout
    (``conformer_encoder.py:169-185``). The layer norm is flax's unnamed
    inner ``LayerNorm_0``, folded into this module (``flax_inner``) as
    ``convert.py`` folds it."""
    flax_inner = "LayerNorm_0"

    def __init__(self, dim: int, expansion: int, dtype: torch.dtype,
                 generator: torch.Generator, drop: _Dropout):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.ff1 = Dense(dim, dim * expansion, dtype, generator)
        self.ff2 = Dense(dim * expansion, dim, dtype, generator)
        self.dtype, self.drop = dtype, drop

    def forward(self, x, train: bool = False,
                generator: torch.Generator = None):
        h = _layer_norm(x, self.weight, self.bias, self.dtype)
        h = self.drop(F.silu(self.ff1(h)), train, generator)
        return self.drop(self.ff2(h), train, generator)


class _ConvModule(nn.Module):
    """LN -> pointwise (2D) + GLU -> time mask -> depthwise (k) -> LN ->
    swish -> pointwise (``conformer_encoder.py:188-264``, layer-norm
    variant), its ten parameters under the flax names and layouts, then
    dropout. With ``fused`` it is
    :func:`ops.conformer_conv.conformer_conv_module` (kernel B6 on the
    card); otherwise the chain below in the compute dtype."""

    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype,
                 fused: bool, generator: torch.Generator,
                 drop: _Dropout = _Dropout(1.0, 32)):
        super().__init__()
        init = resolve_initializer(None)

        def kernel(fan_out, fan_in):
            w = torch.empty(fan_out, fan_in)
            init(w, generator)
            return nn.Parameter(w.t().contiguous())

        self.ln1_scale = nn.Parameter(torch.ones(dim))
        self.ln1_bias = nn.Parameter(torch.zeros(dim))
        self.pw1_kernel = kernel(2 * dim, dim)              # (D, 2D)
        self.pw1_bias = nn.Parameter(torch.zeros(2 * dim))
        self.dw_kernel = kernel(dim, kernel_size)           # (k, D)
        self.dw_bias = nn.Parameter(torch.zeros(dim))
        self.ln2_scale = nn.Parameter(torch.ones(dim))
        self.ln2_bias = nn.Parameter(torch.zeros(dim))
        self.pw2_kernel = kernel(dim, dim)                  # (D, D)
        self.pw2_bias = nn.Parameter(torch.zeros(dim))
        self.kernel_size, self.dtype, self.fused = kernel_size, dtype, fused
        self.drop = drop

    def _ln(self, v, scale, bias):
        return conformer_conv._layer_norm(v.float(), scale, bias,
                                          conformer_conv.EPS).to(self.dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None):
        return self.drop(self._module(x, lengths), train, generator)

    def _module(self, x, lengths):
        if self.fused:
            return conformer_conv.conformer_conv_module(
                x, lengths, self.ln1_scale, self.ln1_bias, self.pw1_kernel,
                self.pw1_bias, self.dw_kernel, self.dw_bias, self.ln2_scale,
                self.ln2_bias, self.pw2_kernel, self.pw2_bias)
        dt, k = self.dtype, self.kernel_size
        h = self._ln(x, self.ln1_scale, self.ln1_bias)
        h = h @ self.pw1_kernel.to(dt) + self.pw1_bias.to(dt)
        h = F.glu(h, dim=-1)
        # padded frames must not leak through the depthwise receptive field
        h = _mask_time(h, lengths)
        lo, hi = same_padding(h.shape[1], k, 1, 1)
        h = F.conv1d(F.pad(h.transpose(1, 2), (lo, hi)),
                     self.dw_kernel.to(dt).t().unsqueeze(1),
                     groups=h.shape[-1]).transpose(1, 2) + \
            self.dw_bias.to(dt)
        h = F.silu(self._ln(h, self.ln2_scale, self.ln2_bias))
        return h @ self.pw2_kernel.to(dt) + self.pw2_bias.to(dt)


class ConformerBlock(nn.Module):
    """``x + FFN/2``, ``+ attention(LN(x))``, ``+ conv module``, ``+
    FFN/2``, then a layer norm (``conformer_encoder.py:267-296``)."""

    def __init__(self, dim: int, num_heads: int, conv_kernel_size: int,
                 ffn_expansion: int, dtype: torch.dtype, fused_conv: bool,
                 flash_attention: bool, generator: torch.Generator,
                 drop: _Dropout, attention_drop: _Dropout):
        super().__init__()
        self.ffn1 = _FFN(dim, ffn_expansion, dtype, generator, drop)
        self.attn_ln = LayerNorm(dim, dtype)
        self.attn = RelPosSelfAttention(dim, num_heads, dtype,
                                        flash_attention, generator,
                                        attention_drop)
        self.conv = _ConvModule(dim, conv_kernel_size, dtype, fused_conv,
                               generator, drop)
        self.ffn2 = _FFN(dim, ffn_expansion, dtype, generator, drop)
        self.final_ln = LayerNorm(dim, dtype)
        self.drop = drop

    def forward(self, x, lengths, pad_mask, train: bool = False,
                generator: torch.Generator = None):
        x = x + 0.5 * self.ffn1(x, train, generator)
        attn = self.attn(self.attn_ln(x), lengths, pad_mask, train, generator)
        x = x + self.drop(attn, train, generator)
        x = x + self.conv(x, lengths, train, generator)
        x = x + 0.5 * self.ffn2(x, train, generator)
        return self.final_ln(x)


class ConformerNet(nn.Module):
    """The module behind :class:`ConformerEncoder`: (B, T, F) features and
    (B,) lengths in, (B, ceil(ceil(T / 2) / 2), D) outputs and lengths
    out (``conformer_encoder.py:299-347``)."""

    def __init__(self, in_features: int, num_layers: int, hidden_size: int,
                 num_heads: int, conv_kernel_size: int, ffn_expansion: int,
                 subsampling_channels: int, dtype: torch.dtype,
                 fused_conv: bool, flash_attention: bool,
                 generator: torch.Generator, dropout_keep_prob: float = 1.0,
                 attention_dropout_keep_prob: float = 1.0,
                 dropout_bits: int = 32):
        super().__init__()
        C = subsampling_channels
        init = resolve_initializer(None)
        self.sub_conv1 = SameConv2d(1, C, (3, 3), (2, 2), dtype, init,
                                    generator)
        self.sub_conv2 = SameConv2d(C, C, (3, 3), (2, 2), dtype, init,
                                    generator)
        freq = -(-in_features // 4)          # ceil(ceil(F / 2) / 2)
        self.sub_proj = Dense(freq * C, hidden_size, dtype, generator)
        self.drop = _Dropout(dropout_keep_prob, dropout_bits)
        attention_drop = _Dropout(attention_dropout_keep_prob, dropout_bits)
        for i in range(num_layers):
            self.add_module("block{}".format(i), ConformerBlock(
                hidden_size, num_heads, conv_kernel_size, ffn_expansion,
                dtype, fused_conv, flash_attention, generator, self.drop,
                attention_drop))
        self.num_layers, self.dtype = num_layers, dtype

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, generator: torch.Generator = None):
        x = feats.to(self.dtype)[..., None]                 # (B, T, F, 1)
        for conv in (self.sub_conv1, self.sub_conv2):
            x = F.silu(conv(x))
            lengths = _out_length(lengths, 2)
        B, T, Fr, C = x.shape
        x = self.drop(self.sub_proj(x.reshape(B, T, Fr * C)), train,
                      generator)
        pad_mask = torch.arange(T, device=x.device)[None, :] < \
            lengths[:, None]
        for i in range(self.num_layers):
            x = self._modules["block{}".format(i)](x, lengths, pad_mask,
                                                   train, generator)
        return _mask_time(x, lengths), lengths


class ConformerEncoderModule(nn.Module):

    def __init__(self, net: ConformerNet):
        super().__init__()
        self.net = net
        self.out_features = net.sub_proj.weight.shape[0]

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(x, lengths, train, generator)
        return {"outputs": outputs, "src_length": out_len}


class ConformerEncoder(Encoder):
    """Config wrapper, same schema and defaults as the JAX package's."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "num_layers": int,
            "hidden_size": int,
            "num_heads": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "conv_kernel_size": int,        # depthwise kernel (paper: 31)
            "ffn_expansion": int,           # macaron FFN width multiple
            "subsampling_channels": int,    # front-end conv channels
            "dropout_keep_prob": float,
            "attention_dropout_keep_prob": float,
            "conv_norm": ["layer_norm", "batch_norm"],
            # the conv module on kernel B6 (layer_norm only)
            "fused_conv_module": bool,
            # the attention on kernel B5
            "flash_attention": bool,
        })

    def __init__(self, params, model, name="conformer_encoder",
                 mode="train"):
        super().__init__(params, model, name, mode)
        norm = self._params.get("conv_norm", "layer_norm")
        if not conformer_conv.supported(norm):
            raise NotImplementedError("conv_norm {!r} is not ported (neither "
                                      "TPU kernel computes it, and its "
                                      "running statistics are training "
                                      "state); layer_norm is".format(norm))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> ConformerEncoderModule:
        p = self._params
        return ConformerEncoderModule(ConformerNet(
            in_features=in_features,
            num_layers=p["num_layers"],
            hidden_size=p["hidden_size"],
            num_heads=p["num_heads"],
            conv_kernel_size=p.get("conv_kernel_size", 31),
            ffn_expansion=p.get("ffn_expansion", 4),
            subsampling_channels=p.get("subsampling_channels",
                                       p["hidden_size"] // 4),
            dtype=self.compute_dtype,
            fused_conv=p.get("fused_conv_module", False),
            flash_attention=p.get("flash_attention", False),
            generator=generator,
            dropout_keep_prob=p.get("dropout_keep_prob", 0.9),
            attention_dropout_keep_prob=p.get(
                "attention_dropout_keep_prob",
                p.get("dropout_keep_prob", 0.9)),
            dropout_bits=32 if self._model is None
            else self._model.params.get("dropout_bits", 32)))
