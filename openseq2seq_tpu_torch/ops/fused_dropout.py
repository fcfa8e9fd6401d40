"""Fused dropout (+ residual add) on the hand-written CUDA kernel
``csrc/dropout_mask.cu`` (kernel B2).

Port of ``openseq2seq_tpu/ops/dropout_pallas.py``:
:func:`fused_dropout` is ``_fd`` and :func:`fused_dropout_add` is
``_fda``, each with its custom VJP: the backward applies the same mask,
regenerated from the saved seed, to the cotangent (``dy = mask * g / q``,
and ``dx = g`` for the residual). The bits are the JAX package's
interpret-mode stream, a counter hash of (seed, row, column)
(``_bits``, ``dropout_pallas.py:69-89``; the TPU's hardware PRNG is not
reproducible off the TPU): :func:`mask_bits_plain` computes it, and the
plain versions :func:`fused_dropout_plain` and
:func:`fused_dropout_add_plain` match ``_fd``/``_fda`` in interpret mode
bit for bit. The keep probability is quantized to a multiple of 2^-32 and
kept values are rescaled by the quantized value (:func:`thr_q`).

The seed is one int32 per call site and step, a (1,) tensor on the
tensor's device (:func:`draw_seed`, the counterpart of
``_seed_from_key``): the kernel reads it from device memory.

For a CPU tensor the op runs the plain version. For a CUDA tensor it
launches the kernel (bf16 or fp32, contiguous, last dim a multiple of 8,
16-byte aligned) or raises on anything the kernel does not take. There is
no other fallback. ``supported`` is the JAX package's routing rule (last
dim a multiple of 128); the callers take the unfused dropout otherwise.

``LAUNCHES`` counts launches of the kernel, forward and backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

LAUNCHES = 0
KERNEL = "dropout_mask"
_MASK32 = 0xFFFFFFFF
_fn = []

Seed = Union[int, torch.Tensor]


def _kernel():
    if not _fn:
        from ..kernels import build
        fn = getattr(build.load(KERNEL), KERNEL)
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def thr_q(rate: float) -> Tuple[int, float]:
    """The uint32 keep threshold and the keep probability it encodes
    (``_thr_q``, ``dropout_pallas.py:62-66``)."""
    keep = 1.0 - rate
    thr = min(2 ** 32 - 1, max(1, int(round(keep * 2.0 ** 32))))
    return thr, thr / 2.0 ** 32


def supported(shape) -> bool:
    """The JAX package's rule for taking the fused route: a last dim that
    is a multiple of 128."""
    return shape[-1] % 128 == 0


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One int32 seed, a (1,) tensor on ``device``, drawn from the step's
    generator without a host sync."""
    if generator is None:
        raise ValueError("fused dropout in training needs a torch.Generator")
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                         device=device, dtype=torch.int32)


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1)
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2^32`` for int64 ``a`` in [0, 2^32), in two 16-bit
    halves of ``k`` so that no int64 product overflows."""
    return (a * (k & 0xFFFF) + (((a * (k >> 16)) & 0xFFFF) << 16)) & _MASK32


def mask_bits_plain(M: int, D: int, seed: Seed, device) -> torch.Tensor:
    """The (M, D) uint32 bits of the JAX package's interpret stream, as
    int64: row r, column c, seed read as uint32, arithmetic mod 2^32."""
    r = torch.arange(M, device=device, dtype=torch.int64)[:, None]
    c = torch.arange(D, device=device, dtype=torch.int64)[None, :]
    s = (_seed_tensor(seed, device).to(device).long() & _MASK32) + \
        _mul32(r >> 8, 0x9E3779B1)
    h = ((_mul32(r & 255, 0x85EBCA77) ^ _mul32(c, 0xC2B2AE3D)) + s) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _plain(y: torch.Tensor, x: Optional[torch.Tensor], rate: float,
           seed: Seed) -> torch.Tensor:
    thr, q = thr_q(rate)
    D = y.shape[-1]
    keep = (mask_bits_plain(y.numel() // D, D, seed, y.device) < thr) \
        .reshape(y.shape)
    out = torch.where(keep, y.float() * (1.0 / q), 0.0)
    if x is not None:
        out = out + x.float()
    return out.to(y.dtype)


def _check(y, x, seed):
    dev = y.device
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("y must be bf16 or fp32, got {}".format(y.dtype))
    if y.dim() < 1 or y.numel() == 0 or y.shape[-1] % 8 != 0:
        raise ValueError("y must be non-empty with a last dim that is a "
                         "multiple of 8, got shape {}".format(tuple(y.shape)))
    for name, t in (("y", y), ("x", x)):
        if t is None:
            continue
        if t.device != dev or t.dtype != y.dtype or t.shape != y.shape:
            raise ValueError("{} must be a {} {} tensor on {}; got {} {} on "
                             "{}".format(name, y.dtype, tuple(y.shape), dev,
                                         t.dtype, tuple(t.shape), t.device))
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError("{} must be contiguous and 16-byte aligned"
                             .format(name))
    if not isinstance(seed, torch.Tensor) or seed.device != dev or \
            seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("seed must be a one-element int32 tensor on {}"
                         .format(dev))


def fused_dropout_cuda(y: torch.Tensor, x: Optional[torch.Tensor],
                       rate: float, seed: torch.Tensor) -> torch.Tensor:
    """Launch ``dropout_mask``; raises on what it does not take."""
    global LAUNCHES
    if y.device.type != "cuda":
        raise ValueError("no fused dropout kernel for device {}".format(
            y.device))
    _check(y, x, seed)
    thr, q = thr_q(rate)
    D = y.shape[-1]
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(y.data_ptr(), None if x is None else x.data_ptr(),
                        out.data_ptr(), seed.data_ptr(), y.numel() // D, D,
                        thr, 1.0 / q, int(y.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return out


def _apply(y, x, rate, seed):
    if y.device.type == "cpu":
        return _plain(y, x, rate, seed)
    return fused_dropout_cuda(y, x, rate, seed)


class _FusedDropout(torch.autograd.Function):
    """``(x +) dropout(y)``; the backward runs the same mask on the
    cotangent for y and passes it through for x (``_fda_bwd``,
    ``_fd_bwd``)."""

    @staticmethod
    def forward(ctx, y, x, rate, seed):
        ctx.rate = rate
        ctx.has_x = x is not None
        ctx.save_for_backward(seed)
        return _apply(y, x, rate, seed)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        dy = _apply(g.contiguous(), None, ctx.rate, seed)
        return dy, (g if ctx.has_x else None), None, None


def fused_dropout(y: torch.Tensor, rate: float, seed: Seed) -> torch.Tensor:
    """``dropout(y, rate)`` with the hashed mask; y unchanged at rate 0."""
    if rate <= 0.0:
        return y
    return _FusedDropout.apply(y, None, float(rate),
                               _seed_tensor(seed, y.device))


def fused_dropout_add(x: torch.Tensor, y: torch.Tensor, rate: float,
                      seed: Seed) -> torch.Tensor:
    """``x + dropout(y, rate)`` in one pass; ``x + y`` at rate 0."""
    if rate <= 0.0:
        return x + y
    return _FusedDropout.apply(y, x, float(rate),
                               _seed_tensor(seed, y.device))


def fused_dropout_plain(y: torch.Tensor, rate: float,
                        seed: Seed) -> torch.Tensor:
    """The plain version of :func:`fused_dropout` (no autograd rule)."""
    return y if rate <= 0.0 else _plain(y, None, float(rate), seed)


def fused_dropout_add_plain(x: torch.Tensor, y: torch.Tensor, rate: float,
                            seed: Seed) -> torch.Tensor:
    """The plain version of :func:`fused_dropout_add`."""
    return x + y if rate <= 0.0 else _plain(y, x, float(rate), seed)
