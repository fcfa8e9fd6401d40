"""Dropout drawn from an explicit ``torch.Generator`` (port of the
training half of ``openseq2seq_tpu/parts/dropout.py``): :func:`dropout`
(with ``broadcast_dims``, one mask shared along those dimensions, as
flax's ``Dropout(broadcast_dims=...)`` draws it), the transformer FFN's
:func:`relu_dropout` and the language model's whole-word
:func:`word_dropout_scale`.

The mask is ``torch.rand(shape, generator=g) < keep`` on the tensor's
device: never ``F.dropout`` or torch's global generator, so a run is
reproducible from its seed and a resumed run draws what an uninterrupted
one would (the trainer seeds the generator from ``(random_seed, step)``,
see :func:`step_seed`).

``dropout_bits`` keeps the JAX package's meaning (``parts/dropout.py:
193-200``): 32 keeps with probability ``keep`` and rescales by ``keep``;
8 quantizes the keep probability to ``t / 256`` with ``t = clamp(round(
keep * 256), 1, 255)`` and rescales kept values by the same ``t / 256``,
so the expectation stays exact. The masks themselves cannot match JAX's
bit for bit: the two frameworks' generators differ.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_MASK64 = (1 << 64) - 1


def keep_spec(keep_prob: float, dropout_bits: int = 32
              ) -> Tuple[float, float]:
    """(probability of keeping an element, rescale of kept values)."""
    if dropout_bits == 8:
        t = min(255, max(1, int(round(keep_prob * 256.0))))
        return t / 256.0, t / 256.0
    if dropout_bits not in (None, 32):
        raise ValueError("dropout_bits must be 8 or 32, got {!r}".format(
            dropout_bits))
    return keep_prob, keep_prob


def dropout(x: torch.Tensor, keep_prob: float, generator: torch.Generator,
            dropout_bits: int = 32,
            broadcast_dims: Tuple[int, ...] = ()) -> torch.Tensor:
    """``where(rand < p, x / q, 0)`` with (p, q) from :func:`keep_spec`,
    the mask drawn with size 1 along ``broadcast_dims`` (the language
    model's (B, 1, D) masks, shared over time) and broadcast; ``x``
    unchanged when ``keep_prob >= 1``."""
    if keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    p, q = keep_spec(keep_prob, dropout_bits)
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]
    mask = torch.rand(shape, generator=generator, device=x.device) < p
    return torch.where(mask, x / q, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def relu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 dropout_bits: int = 32) -> torch.Tensor:
    """relu, then dropout at ``rate`` (``parts/dropout.py:183-191``);
    relu alone at rate 0. Its gradient, ``mask * 1[x > 0] * g / q`` from
    autograd, is the JAX package's mask-free VJP ``1[out > 0] * g / q``
    wherever x != 0."""
    h = torch.relu(x)
    if rate <= 0.0:
        return h
    return dropout(h, 1.0 - rate, generator, dropout_bits)


def word_dropout_scale(ids: torch.Tensor, vocab_size: int, keep_prob: float,
                       generator: Optional[torch.Generator],
                       dtype: torch.dtype) -> torch.Tensor:
    """The embedding's whole-word dropout (``encoders/lm_encoders.py:
    56-62``): one exact Bernoulli(keep_prob) draw per vocabulary entry,
    (V, 1), scaled by 1 / keep_prob (0 where dropped), rounded to
    ``dtype`` and gathered by ``ids``: (..., 1), to multiply the embedded
    words by, so that every occurrence of a dropped word is dropped."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand((vocab_size, 1), generator=generator,
                      device=ids.device) < keep_prob
    scale = torch.where(keep, 1.0 / keep_prob, 0.0).to(dtype)
    return scale[ids.long()]


def bernoulli(p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """One Bernoulli(p) draw as a 0-d bool tensor on ``device`` (no host
    sync)."""
    if generator is None:
        raise ValueError("a random draw in training needs a "
                         "torch.Generator")
    return torch.rand((), generator=generator, device=device) < p


def step_seed(seed: int, step: int) -> int:
    """The seed of training step ``step`` of a run seeded ``seed`` (the
    counterpart of ``jax.random.fold_in(base_rng, step)``): a splitmix64
    mix of the two, so nearby steps get unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1          # manual_seed takes < 2**63
