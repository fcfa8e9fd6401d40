"""Flash attention on the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu`` (kernel B7, forward).

Port of ``openseq2seq_tpu/parts/transformer/attention.py:120``
``_attend_flash``, which calls JAX's stock Pallas TPU flash attention.
:func:`flash_attention` computes ``softmax(q k^T * sm_scale + mask) v``
in JAX's layout, (B, T, H, D), with a (B, Tk) key-valid mask and a
causal flag (key k > query q masked). A masked key gets the finite
additive -1e9 of ``_attend``'s bias, in the kernel and in
:func:`flash_attention_plain`, its plain PyTorch twin.

For a CPU tensor the op runs the plain version. For a CUDA tensor it
launches the kernel (bf16 or fp32; D in {64, 128, 256}; contiguous
inputs) or raises on anything the kernel does not take. There is no
other fallback. The op is forward only: it raises when a gradient would
be needed (the backward comes with transformer training).

``LAUNCHES`` counts launches of the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0
KERNEL = "flash_attn_fwd"
HEAD_DIMS = (64, 128, 256)
MASKED = -1e9
_fn = []


def _kernel():
    if not _fn:
        from ..kernels import build
        fn = getattr(build.load(KERNEL), KERNEL)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: fp32 scores, the mask as an additive -1e9,
    softmax, then the weighted sum of v in fp32; output in q's dtype."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    masked = torch.zeros((1, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        masked = masked | ~kv_valid.bool()[:, None, None, :]
    if causal:
        masked = masked | torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device).triu(1)
    logits = logits + torch.where(masked, MASKED, 0.0)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def _check(q, k, v, kv_valid):
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError("{} is on {}, q on {}".format(name, x.device,
                                                           dev))
        if x.dtype not in (torch.bfloat16, torch.float32) or \
                x.dtype != q.dtype:
            raise ValueError("q, k, v must all be bf16 or all fp32; got {}, "
                             "{}, {}".format(q.dtype, k.dtype, v.dtype))
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError("{} must be a contiguous (B, T, H, D) tensor, "
                             "got shape {}".format(name, tuple(x.shape)))
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError("head dim {} not in {}".format(D, HEAD_DIMS))
    if k.shape != (B, Tk, H, D) or v.shape != (B, Tk, H, D):
        raise ValueError("shapes differ: q {}, k {}, v {}".format(
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if min(B, Tq, Tk, H) < 1:
        raise ValueError("empty input: q {}, k {}".format(tuple(q.shape),
                                                          tuple(k.shape)))
    if kv_valid is not None and (
            kv_valid.device != dev or kv_valid.dtype != torch.bool or
            kv_valid.shape != (B, Tk) or not kv_valid.is_contiguous()):
        raise ValueError("kv_valid must be a contiguous bool (B, Tk) = {} "
                         "tensor on {}; got {} {} on {}".format(
                             (B, Tk), dev, kv_valid.dtype,
                             tuple(kv_valid.shape), kv_valid.device))
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("flash_attention is forward only; its "
                                  "backward comes with transformer "
                                  "training")


def flash_attention_cuda(q, k, v, kv_valid=None, causal=False,
                         sm_scale=None) -> torch.Tensor:
    """Launch ``flash_attn_fwd``; raises on what it does not take."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError("no flash attention kernel for device {}".format(
            q.device))
    _check(q, k, v, kv_valid)
    B, Tq, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if kv_valid is None else kv_valid.data_ptr(),
                        out.data_ptr(), B, Tq, k.shape[1], H, D,
                        int(q.dtype == torch.bfloat16), int(bool(causal)),
                        float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale + mask) v, (B, T, H, D) in and out:
    the plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, causal, sm_scale)
    return flash_attention_cuda(q, k, v, kv_valid, causal, sm_scale)
