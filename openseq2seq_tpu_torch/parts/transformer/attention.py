"""Multi-head attention with a KV cache (port of
``openseq2seq_tpu/parts/transformer/attention.py``).

  * :class:`SelfAttention`: one fused ``qkv`` projection, split into q,
    k, v in that order, then ``out``; for decoding, a per-layer cache,
    time first, that :meth:`SelfAttention.decode_step` writes at the
    step's position in place and attends over its prefix ``[0, pos]``.
    That is exact: the
    JAX package attends over the whole cache with -1e7 on the positions
    past ``pos``, whose weights exp(-1e7 - m) are 0 in fp32.
  * :class:`CrossAttention`: ``q``, ``k``, ``v``, ``out``, with K/V of
    the encoder memory projected once per sequence
    (:meth:`CrossAttention.precompute_kv`).
  * :func:`_attend`: the plain path, fp32 scores from the compute-dtype
    operands, fp32 softmax, weights cast back to the compute dtype.

Where the JAX package calls its TPU flash kernel (``use_flash`` and
``_flash_ok``, full-sequence attention only), the port calls its flash
kernel (``ops/flash_attention.py``, B7) on CUDA tensors: head dim in
{64, 128, 256} and min(Tq, Tk) > 1, with "CUDA" in place of "tpu".
The bias rule is ``_attend_flash``'s: under ``causal`` the bias is
ignored (the kernel's own mask replaces the triangle); otherwise a
(B|1, 1, 1, Tk) key-padding bias becomes a key-valid mask by
``bias > -1``, and any other bias shape raises. In training the
attention dropout (``attention_dropout``, from the step's generator,
honouring ``dropout_bits``) runs on the weights on the plain path
(``attention.py:39-48``) and on the attention output on the flash path
(``attention.py:278-280``, ``:329-332``), as in the JAX package; the flash
kernels' backward gives the gradient of the flash path.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ...ops.flash_attention import HEAD_DIMS, flash_attention
from ..dropout import dropout
from .common import Dense


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, T, h, d = x.shape
    return x.reshape(B, T, h * d)


def _attend(q, k, v, bias: Optional[torch.Tensor],
            drop: Optional[Callable] = None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + bias) v`` as the JAX package computes
    it: q scaled in its dtype, fp32 scores and softmax (the bf16 operands
    upcast exactly), ``drop`` on the fp32 weights in training, weights
    cast to v's dtype for the second product."""
    q = q * (q.shape[-1] ** -0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    if drop is not None:
        weights = drop(weights)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def _dropper(rate: float, bits: int, train: bool,
             generator: Optional[torch.Generator]) -> Optional[Callable]:
    """The attention dropout of a training call, or None."""
    if not train or rate <= 0.0:
        return None
    return lambda x: dropout(x, 1.0 - rate, generator, bits)


def _flash_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the flash kernel applies to these shapes and device."""
    return q.is_cuda and q.shape[-1] in HEAD_DIMS and \
        min(q.shape[1], k.shape[1]) > 1


def _attend_flash(q, k, v, bias: Optional[torch.Tensor],
                  causal: bool) -> torch.Tensor:
    B, Tk = q.shape[0], k.shape[1]
    kv_valid = None
    if bias is not None and not causal:
        if tuple(bias.shape) not in ((B, 1, 1, Tk), (1, 1, 1, Tk)):
            raise ValueError("the flash path supports only (B,1,1,Tk) "
                             "key-padding biases; got bias shape {}".format(
                                 tuple(bias.shape)))
        kv_valid = (bias.reshape(-1, Tk) > -1.0).expand(B, Tk).contiguous()
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           kv_valid, causal, q.shape[-1] ** -0.5)


class SelfAttention(nn.Module):
    """Fused-QKV self-attention. ``causal`` tells the flash path to mask
    k > q; callers pass the causal bias as well, which the plain path
    uses."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator, use_flash: bool = False,
                 causal: bool = False, attention_dropout: float = 0.0,
                 dropout_bits: int = 32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.causal = causal
        self.attention_dropout = attention_dropout
        self.dropout_bits = dropout_bits
        self.qkv = Dense(hidden_size, 3 * hidden_size, dtype, generator)
        self.out = Dense(hidden_size, hidden_size, dtype, generator)

    def _qkv(self, x):
        q, k, v = self.qkv(x).split(self.hidden_size, dim=-1)
        return [_split_heads(t, self.num_heads) for t in (q, k, v)]

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Full-sequence attention over x (B, T, d)."""
        q, k, v = self._qkv(x)
        drop = _dropper(self.attention_dropout, self.dropout_bits, train,
                        generator)
        if self.use_flash and _flash_ok(q, k):
            out = _attend_flash(q, k, v, bias, self.causal)
            if drop is not None:
                out = drop(out)       # weight dropout -> output dropout
        else:
            out = _attend(q, k, v, bias, drop)
        return self.out(_merge_heads(out))

    def decode_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        """One decode step, x (N, 1, d): writes this step's k and v into
        the caches (T_max, N, h, dh), time first, at ``pos``, in place,
        and attends over positions [0, pos]. A cache may be wider than
        the compute dtype (an fp32 k cache spares ``_attend`` its upcast):
        the values it holds are the compute dtype's, so the result is the
        same."""
        q, k, v = self._qkv(x)
        k_cache[pos] = k[:, 0]
        v_cache[pos] = v[:, 0]
        out = _attend(q, k_cache[:pos + 1].transpose(0, 1),
                      v_cache[:pos + 1].transpose(0, 1), None)
        return self.out(_merge_heads(out))


class CrossAttention(nn.Module):
    """Encoder-decoder attention; K/V from the memory or precomputed."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator, use_flash: bool = False,
                 attention_dropout: float = 0.0, dropout_bits: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.attention_dropout = attention_dropout
        self.dropout_bits = dropout_bits
        self.q = Dense(hidden_size, hidden_size, dtype, generator)
        self.k = Dense(hidden_size, hidden_size, dtype, generator)
        self.v = Dense(hidden_size, hidden_size, dtype, generator)
        self.out = Dense(hidden_size, hidden_size, dtype, generator)

    def precompute_kv(self, memory: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"k": _split_heads(self.k(memory), self.num_heads),
                "v": _split_heads(self.v(memory), self.num_heads)}

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        q = _split_heads(self.q(x), self.num_heads)
        kv = kv_cache if kv_cache is not None else self.precompute_kv(memory)
        k, v = kv["k"], kv["v"]
        drop = _dropper(self.attention_dropout, self.dropout_bits, train,
                        generator)
        # flash only over full sequences; decode queries (Tq = 1) and the
        # precomputed K/V of decoding stay on the plain path
        if self.use_flash and kv_cache is None and _flash_ok(q, k):
            out = _attend_flash(q, k, v, bias, False)
            if drop is not None:
                out = drop(out)       # weight dropout -> output dropout
        else:
            out = _attend(q, k, v, bias, drop)
        return self.out(_merge_heads(out))
