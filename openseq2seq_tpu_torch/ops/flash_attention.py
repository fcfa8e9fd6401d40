"""Flash attention on the hand-written CUDA kernels
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu`` (kernel B7,
forward and backward).

Port of ``openseq2seq_tpu/parts/transformer/attention.py:120``
``_attend_flash``, which calls JAX's stock Pallas TPU flash attention
and, in training, its custom VJP (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``). :func:`flash_attention` computes
``softmax(q k^T * sm_scale + mask) v`` in JAX's layout, (B, T, H, D),
with a (B, Tk) key-valid mask and a causal flag (key k > query q
masked). A masked key gets the finite additive -1e9 of ``_attend``'s
bias, in the kernels and in the plain PyTorch twins
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`.

When a gradient is needed the op is a ``torch.autograd.Function`` on both
devices: its forward also returns each row's log-sum-exp ``lse``
(B, H, Tq), fp32, and its backward recomputes the weights from it
(FlashAttention-2: ``di = rowsum(dO * O)``, ``ds = p * (dO v^T - di)``)
and gives dq, dk and dv in the inputs' dtype. A row without any valid key
(all its keys masked) has its lse taken relative to the mask value, which
fp32 could not add to log(l) at -1e9; the backward subtracts the same
offset.

For a CPU tensor the op runs the plain versions. For a CUDA tensor it
launches the kernels (bf16 or fp32; D in {64, 128, 256}; contiguous
inputs) or raises on anything they do not take. There is no other
fallback. ``LAUNCHES`` counts launches of the forward kernel,
``BWD_DQ_LAUNCHES`` and ``BWD_DKV_LAUNCHES`` those of the two backward
kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
HEAD_DIMS = (64, 128, 256)
MASKED = -1e9
# entry point -> (library, pointer arguments)
_ENTRY = {"flash_attn_fwd": (KERNEL, 6), "flash_attn_bwd_dq": (BWD_KERNEL, 9),
          "flash_attn_bwd_dkv": (BWD_KERNEL, 9)}
_fns = {}


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        from ..kernels import build
        lib, n_ptr = _ENTRY[entry]
        fn = getattr(build.load(lib), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def _scores(q, k, kv_valid, causal, sm_scale):
    """fp32 scaled scores with the mask added, (B, H, Tq, Tk), and the
    per-row offset, -1e9 on a row without any valid key and 0 elsewhere."""
    Tq, Tk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    masked = torch.zeros((1, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        masked = masked | ~kv_valid.bool()[:, None, None, :]
    if causal:
        masked = masked | torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device).triu(1)
    off = torch.where(masked.all(-1, keepdim=True), MASKED, 0.0)
    return logits + torch.where(masked, MASKED, 0.0), off


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          sm_scale: Optional[float] = None,
                          return_lse: bool = False):
    """The plain version: fp32 scores, the mask as an additive -1e9,
    softmax, then the weighted sum of v in fp32; output in q's dtype.
    With ``return_lse`` also the rows' log-sum-exp (B, H, Tq), fp32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits, off = _scores(q, k, kv_valid, causal, sm_scale)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits - off, dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid=None,
                              causal=False, sm_scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain version of the backward, the kernels' recompute written
    out in fp32: p from ``lse``, ``di = rowsum(dO * O)``,
    ``ds = p * (dO v^T - di)``; (dq, dk, dv) in the inputs' dtypes."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits, off = _scores(q, k, kv_valid, causal, sm_scale)
    p = torch.exp((logits - off) - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    di = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def flash_attention_cuda(q, k, v, kv_valid=None, causal=False,
                         sm_scale=None, return_lse: bool = False):
    """Launch ``flash_attn_fwd``; with ``return_lse`` also the rows'
    log-sum-exp (B, H, Tq), fp32. Raises on what it does not take."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError("no flash attention kernel for device {}".format(
            q.device))
    _check(q, k, v, kv_valid)
    B, Tq, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(KERNEL)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, Tq,
            k.shape[1], H, D, int(q.dtype == torch.bfloat16),
            int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_valid=None,
                             causal=False, sm_scale=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch ``flash_attn_bwd_dq`` (which also writes di) and then
    ``flash_attn_bwd_dkv``; raises on what they do not take."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError("no flash attention kernel for device {}".format(
            q.device))
    _check(q, k, v, kv_valid)
    B, Tq, H, D = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or \
                x.device != q.device or not x.is_contiguous():
            raise ValueError("{} must be a contiguous {} {} tensor on {}"
                             .format(name, q.dtype, tuple(q.shape),
                                     q.device))
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 {} tensor on {}"
                         .format((B, H, Tq), q.device))
    if sm_scale is None:
        sm_scale = D ** -0.5
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    di = torch.empty_like(lse)
    mask = None if kv_valid is None else kv_valid.data_ptr()
    ints = (B, Tq, k.shape[1], H, D, int(q.dtype == torch.bfloat16),
            int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("flash_attn_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), mask, dq.data_ptr(),
            di.data_ptr(), *ints, float(sm_scale), stream)
        if err != 0:
            raise RuntimeError("flash_attn_bwd_dq launch failed: CUDA error "
                               "{}".format(err))
        BWD_DQ_LAUNCHES += 1
        err = _kernel("flash_attn_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), mask, dk.data_ptr(),
            dv.data_ptr(), *ints, float(sm_scale), stream)
        if err != 0:
            raise RuntimeError("flash_attn_bwd_dkv launch failed: CUDA "
                               "error {}".format(err))
        BWD_DKV_LAUNCHES += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The op under autograd: the forward keeps lse, the backward runs
    the backward kernels (the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, sm_scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, kv_valid, causal,
                                             sm_scale, return_lse=True)
        else:
            out, lse = flash_attention_cuda(q, k, v, kv_valid, causal,
                                            sm_scale, return_lse=True)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.save_for_backward(q, k, v, out, lse, kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_valid = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), kv_valid,
                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale + mask) v, (B, T, H, D) in and out: the
    plain version for a CPU tensor, the kernels for a CUDA one;
    differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_valid, bool(causal),
                                     float(sm_scale))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, causal, sm_scale)
    return flash_attention_cuda(q, k, v, kv_valid, causal, sm_scale)
