"""Rel-pos flash attention on the hand-written CUDA kernels
``csrc/flash_relpos_fwd.cu`` and ``csrc/flash_relpos_bwd.cu`` (kernel B5,
forward and backward).

Port of ``openseq2seq_tpu/ops/flash_relpos.py``: ``rel_flash_attention``
(``:496-606``) with ``_angles`` (``:453-463``) and ``_build_aug``
(``:466-493``). The Conformer's relative-position score folds exactly into
the q.k product: with g = K_r (q + w) split into its sin and cos halves gs,
gc and the query angles a_i = w_m (i + T - 1),

    A_i = gs sin(a_i) + gc cos(a_i),  B_i = gc sin(a_i) - gs cos(a_i),

the augmented q~ = [q + u | A | B] and k~ = [k | cos(w_m j) | sin(w_m j)]
give the Transformer-XL scores (q+u).k + (q+w).R[i-j] as one inner
product over Dh + D. The g product is a plain product outside the kernel
(``torch.einsum``), in the compute dtype as there. The TPU path pads T to
its block multiple and the head dim to 128 lanes; neither is needed here.
Lengths are clamped to at least 1, so key 0 is always valid and a masked
key (score replaced by -1e30) has weight exactly 0. Query rows past their
length get finite outputs over the valid keys, and carry gradients; the
caller masks them.

When a gradient is needed :func:`rel_flash_attention` is a
``torch.autograd.Function`` on both devices. Its forward keeps lse and the
folded operands (the JAX package rebuilds them in its backward to save
TPU memory; the values are the same). Its backward is ``_bwd_pallas`` and
``_rel_vjp_bwd`` at their precision: delta = rowsum(do . o) in fp32; p
recomputed from lse over the valid keys; dv = p^T do with p rounded to
do's type; ds = p (dp - delta) * scale in fp32, rounded to q's type for
dk = ds^T q[:, :Dh] (the key table is constant) and dq~ = ds k~; then the
fold's backward in the compute dtype, with the two large products dq_w =
dg K_r and dK_r = sum dg (x) q_w left to ``torch.einsum`` as the JAX
package leaves them to XLA.

For CPU tensors the ops run their plain versions (the augmented attention
written out with a (B, H, T, T) score). For CUDA tensors they launch the
kernels (bf16 on the tensor cores, fp32 on the CUDA cores, forward and
backward; Dh in {32, 64, 128}; D a multiple of 32 within the kernels'
shared memory and, for the bf16 backward, Dh + D up to 704) or raise.
There is no other fallback.
``LAUNCHES`` counts launches of the forward kernel, ``BWD_DQ_LAUNCHES``
and ``BWD_DKV_LAUNCHES`` those of the two backward kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
KERNEL = "flash_relpos_fwd"
BWD_KERNEL = "flash_relpos_bwd"
HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30
# the card's shared memory a block can use
SMEM_LIMIT = 232448
# entry point -> (library, pointer arguments, int arguments); the
# ``*_smem`` entries take (Dh, D, is_bf16) and return a byte count
_ENTRY = {"flash_relpos_fwd": (KERNEL, 8, 6),
          "flash_relpos_bwd_dq": (BWD_KERNEL, 12, 6),
          "flash_relpos_bwd_dkv": (BWD_KERNEL, 11, 6)}
_fns = {}


def _kernel(entry: str = KERNEL):
    fn = _fns.get(entry)
    if fn is None:
        from ..kernels import build
        if entry in _ENTRY:
            lib, n_ptr, n_int = _ENTRY[entry]
            fn = getattr(build.load(lib), entry)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + \
                [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        else:
            lib = BWD_KERNEL if entry.startswith(BWD_KERNEL) else KERNEL
            fn = getattr(build.load(lib), entry)
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_longlong
        _fns[entry] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _angles_np(T: int, dim: int):
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
    ang_i = (np.arange(T) + T - 1)[:, None] * inv_freq[None, :]
    ang_j = np.arange(T)[:, None] * inv_freq[None, :]
    return (np.sin(ang_i).astype(np.float32), np.cos(ang_i).astype(np.float32),
            np.concatenate([np.cos(ang_j), np.sin(ang_j)],
                           axis=1).astype(np.float32))


@functools.lru_cache(maxsize=64)
def angles(T: int, dim: int, device="cpu"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(si, ci, k_pos) on ``device``, fp32: the query angles' sines and
    cosines (T, dim / 2) and the key table [cos | sin] (T, dim), computed
    in float64 with numpy and rounded at the end, as ``_angles`` does."""
    return tuple(torch.from_numpy(a).to(device) for a in _angles_np(T, dim))


def position_queries(q_w: torch.Tensor, r_kernel: torch.Tensor,
                     si: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """The fold: q_w (B, T, H, Dh) = q + w and the table projection
    r_kernel (D, H, Dh) -> [A | B] (B, H, T, D) in q_w's dtype, every step
    in that dtype as in ``_build_aug``."""
    g = torch.einsum("bthd,phd->bhtp", q_w, r_kernel.to(q_w.dtype))
    m = g.shape[-1] // 2
    gs, gc = g[..., :m], g[..., m:]
    si, ci = si.to(g.dtype), ci.to(g.dtype)
    return torch.cat([gs * si + gc * ci, gc * si - gs * ci], dim=-1)


def build_aug(q_u, q_w, k, r_kernel) -> Tuple[torch.Tensor, torch.Tensor]:
    """q~ and k~ (B, H, T, Dh + D) from the module's (B, T, H, Dh) tensors,
    as ``_build_aug`` builds them (without its padding)."""
    B, T, H, _ = q_w.shape
    D = r_kernel.shape[0]
    si, ci, k_pos = angles(T, D, q_w.device)
    q_aug = torch.cat([q_u.transpose(1, 2).to(q_w.dtype),
                       position_queries(q_w, r_kernel, si, ci)], dim=-1)
    k_aug = torch.cat([k.transpose(1, 2),
                       k_pos.to(k.dtype).expand(B, H, T, D)], dim=-1)
    return q_aug, k_aug


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, sm_scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain attention over q~, k~ (B, H, T, dqk) and v (B, H, T, dv):
    fp32 scores, keys t >= max(length, 1) replaced by -1e30, softmax with
    p rounded to v's dtype before P.V (l sums the unrounded p). Returns o
    (B, H, T, dv) in q's dtype and lse (B, H, T), fp32."""
    T = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(min=1)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def relpos_attention_plain(qu, qp, k, kp, v, lengths, sm_scale
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version on the kernel's inputs: qu, k, v
    (B, T, H, Dh), qp (B, H, T, D), kp (T, D). Returns the context
    (B, T, H, Dh) and lse (B, H, T)."""
    B, T, H, _ = k.shape
    q_aug = torch.cat([qu.transpose(1, 2), qp], dim=-1)
    k_aug = torch.cat([k.transpose(1, 2),
                       kp.expand(B, H, T, kp.shape[-1])], dim=-1)
    o, lse = flash_attention_plain(q_aug, k_aug, v.transpose(1, 2),
                                   lengths, sm_scale)
    return o.transpose(1, 2).contiguous(), lse


def relpos_attention_bwd_plain(qu, qp, k, kp, v, lengths, o, lse, do,
                               sm_scale):
    """The backward kernels' plain version on the kernel's inputs (as
    :func:`relpos_attention_plain` takes them), the forward's context o
    and lse (B, H, T), and the context's cotangent do (B, T, H, Dh), at
    ``_bwd_pallas``'s precision. Returns dqu (B, T, H, Dh), dqp (B, H, T,
    D), dk and dv (B, T, H, Dh) in the inputs' dtype."""
    B, T, H, Dh = k.shape
    q_aug = torch.cat([qu.transpose(1, 2), qp], dim=-1).float()
    k_aug = torch.cat([k.transpose(1, 2),
                       kp.expand(B, H, T, kp.shape[-1])], dim=-1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q_aug, k_aug) * sm_scale
    lens = lengths.to(device=k.device, dtype=torch.int64).clamp(min=1)
    valid = torch.arange(T, device=k.device)[None, :] < lens[:, None]
    p = torch.where(valid[:, None, None, :], torch.exp(s - lse[..., None]),
                    0.0)
    do_t = do.transpose(1, 2).float()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # (B, H, T)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do_t)
    dp = torch.einsum("bhqd,bhkd->bhqk", do_t, v.transpose(1, 2).float())
    ds = (p * (dp - delta[..., None]) * sm_scale).to(qu.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q_aug[..., :Dh])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k_aug).to(qu.dtype)
    return (dq[..., :Dh].transpose(1, 2).contiguous(),
            dq[..., Dh:].contiguous(),
            dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def _check(qu, qp, k, kp, v, lengths):
    dev, dtype = k.device, k.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("inputs must be bf16 or fp32, got {}".format(dtype))
    B, T, H, Dh = k.shape
    D = kp.shape[-1] if kp.dim() == 2 else -1
    shapes = {"qu": (qu, (B, T, H, Dh)), "qp": (qp, (B, H, T, D)),
              "k": (k, (B, T, H, Dh)), "kp": (kp, (T, D)),
              "v": (v, (B, T, H, Dh))}
    for name, (x, shape) in shapes.items():
        # the kernels read 16 bytes at a time
        if x.device != dev or x.dtype != dtype or \
                tuple(x.shape) != shape or not x.is_contiguous() or \
                x.data_ptr() % 16 != 0:
            raise ValueError("{} must be a contiguous, 16-byte aligned {} "
                             "{} tensor on {}; got {} {} on {}".format(
                                 name, dtype, shape, dev, x.dtype,
                                 tuple(x.shape), x.device))
    if Dh not in HEAD_DIMS or D < 32 or D % 32 != 0 or min(B, T, H) < 1:
        raise ValueError("head dim {} not in {} or table width {} not a "
                         "positive multiple of 32 (B={}, T={}, H={})".format(
                             Dh, HEAD_DIMS, D, B, T, H))
    if lengths.device != dev or lengths.dtype != torch.int32 or \
            tuple(lengths.shape) != (B,) or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 ({},) tensor on "
                         "{}".format(B, dev))


def relpos_attention_cuda(qu, qp, k, kp, v, lengths, sm_scale,
                          return_lse: bool = False):
    """Launch ``flash_relpos_fwd``: the context (B, T, H, Dh) and, with
    ``return_lse``, lse (B, H, T) fp32. ``lengths`` int32 (B,) is clamped
    to at least 1 in the kernel. Raises on what it does not take."""
    global LAUNCHES
    if k.device.type != "cuda":
        raise ValueError("no rel-pos flash kernel for device {}".format(
            k.device))
    _check(qu, qp, k, kp, v, lengths)
    B, T, H, Dh = k.shape
    D = kp.shape[-1]
    is_bf16 = int(k.dtype == torch.bfloat16)
    smem = _kernel("flash_relpos_fwd_smem")(Dh, D, is_bf16)
    if smem > SMEM_LIMIT:
        raise ValueError("head dim {} with table width {} needs {} bytes of "
                         "shared memory, over the card's {}".format(
                             Dh, D, smem, SMEM_LIMIT))
    out = torch.empty_like(v)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=k.device) \
        if return_lse else None
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(qu.data_ptr(), qp.data_ptr(), k.data_ptr(),
                        kp.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), None if lse is None else lse.data_ptr(),
                        B, T, H, Dh, D, is_bf16, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def relpos_attention_bwd_cuda(qu, qp, k, kp, v, lengths, o, lse, do,
                              sm_scale):
    """Launch ``flash_relpos_bwd_dq`` (which also writes delta) and then
    ``flash_relpos_bwd_dkv``: (dqu, dqp, dk, dv) as
    :func:`relpos_attention_bwd_plain` returns them. Raises on what they
    do not take."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    if k.device.type != "cuda":
        raise ValueError("no rel-pos flash kernel for device {}".format(
            k.device))
    _check(qu, qp, k, kp, v, lengths)
    B, T, H, Dh = k.shape
    D = kp.shape[-1]
    for name, x in (("o", o), ("do", do)):
        if x.shape != k.shape or x.dtype != k.dtype or \
                x.device != k.device or not x.is_contiguous() or \
                x.data_ptr() % 16 != 0:
            raise ValueError("{} must be a contiguous {} {} tensor on {}"
                             .format(name, k.dtype, tuple(k.shape),
                                     k.device))
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or \
            lse.device != k.device or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 {} tensor on {}"
                         .format((B, H, T), k.device))
    is_bf16 = int(k.dtype == torch.bfloat16)
    for entry in ("flash_relpos_bwd_dq_smem", "flash_relpos_bwd_dkv_smem"):
        smem = _kernel(entry)(Dh, D, is_bf16)
        if smem > SMEM_LIMIT:
            raise ValueError("head dim {} with table width {} needs {} bytes "
                             "of shared memory in {}, over the card's {}"
                             .format(Dh, D, smem, entry[:-5], SMEM_LIMIT))
    dqu, dqp, dk, dv = (torch.empty_like(x) for x in (qu, qp, k, v))
    delta = torch.empty_like(lse)
    ints = (B, T, H, Dh, D, is_bf16)
    inputs = (qu.data_ptr(), qp.data_ptr(), k.data_ptr(), kp.data_ptr(),
              v.data_ptr(), lengths.data_ptr())
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("flash_relpos_bwd_dq")(
            *inputs, o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dqu.data_ptr(), dqp.data_ptr(), *ints,
            float(sm_scale), stream)
        if err != 0:
            raise RuntimeError("flash_relpos_bwd_dq launch failed: CUDA "
                               "error {}".format(err))
        BWD_DQ_LAUNCHES += 1
        err = _kernel("flash_relpos_bwd_dkv")(
            *inputs, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *ints, float(sm_scale), stream)
        if err != 0:
            raise RuntimeError("flash_relpos_bwd_dkv launch failed: CUDA "
                               "error {}".format(err))
        BWD_DKV_LAUNCHES += 1
    return dqu, dqp, dk, dv


def relpos_attention(qu, qp, k, kp, v, lengths, sm_scale,
                     return_lse: bool = False):
    """The kernel's function on its inputs: the plain version for a CPU
    tensor, the kernel for a CUDA one."""
    if k.device.type == "cpu":
        out, lse = relpos_attention_plain(qu, qp, k, kp, v, lengths,
                                          sm_scale)
        return (out, lse) if return_lse else out
    lens = lengths.to(device=k.device, dtype=torch.int32).contiguous()
    return relpos_attention_cuda(qu, qp, k, kp, v, lens, sm_scale,
                                 return_lse)


def _operands(q_u, q_w, k, r_kernel):
    B, T, H, Dh = q_w.shape
    D = r_kernel.shape[0]
    si, ci, k_pos = angles(T, D, q_w.device)
    return (q_u.to(q_w.dtype).contiguous(),
            position_queries(q_w, r_kernel, si, ci).contiguous(),
            k.contiguous(), k_pos.to(k.dtype))


def fold_bwd(dqp, q_w, r_kernel, si, ci):
    """The fold's backward (``_rel_vjp_bwd``, ``:588-601``): the position
    queries' gradient dqp = [dA | dB] (B, H, T, D) back to dq_w (B, T, H,
    Dh) and dK_r (D, H, Dh), in the compute dtype with fp32 accumulation
    in the two products."""
    m = dqp.shape[-1] // 2
    dA, dB = dqp[..., :m], dqp[..., m:]
    si, ci = si.to(dqp.dtype), ci.to(dqp.dtype)
    dg = torch.cat([dA * si - dB * ci, dA * ci + dB * si], dim=-1)
    dq_w = torch.einsum("bhtp,phd->bthd", dg, r_kernel.to(q_w.dtype))
    dK_r = torch.einsum("bhtp,bthd->phd", dg, q_w)
    return dq_w.to(q_w.dtype), dK_r.to(r_kernel.dtype)


class _RelFlashAttention(torch.autograd.Function):
    """The op under autograd: the forward keeps lse and the folded
    operands, the backward runs the backward kernels (their plain version
    on the CPU) and the fold's backward."""

    @staticmethod
    def forward(ctx, q_u, q_w, k, v, r_kernel, lengths, sm_scale):
        qu, qp, kk, kp = _operands(q_u, q_w, k, r_kernel)
        v = v.contiguous()
        if k.device.type == "cpu":
            lens = lengths
            out, lse = relpos_attention_plain(qu, qp, kk, kp, v, lens,
                                              sm_scale)
        else:
            lens = lengths.to(device=k.device, dtype=torch.int32).contiguous()
            out, lse = relpos_attention_cuda(qu, qp, kk, kp, v, lens,
                                             sm_scale, return_lse=True)
        ctx.sm_scale, ctx.q_u_dtype = sm_scale, q_u.dtype
        ctx.save_for_backward(qu, qp, kk, kp, v, lens, out, lse, q_w,
                              r_kernel)
        return out

    @staticmethod
    def backward(ctx, do):
        qu, qp, kk, kp, v, lens, out, lse, q_w, r_kernel = ctx.saved_tensors
        bwd = relpos_attention_bwd_plain if kk.device.type == "cpu" \
            else relpos_attention_bwd_cuda
        dqu, dqp, dk, dv = bwd(qu, qp, kk, kp, v, lens, out, lse,
                               do.contiguous(), ctx.sm_scale)
        si, ci, _ = angles(q_w.shape[1], r_kernel.shape[0], q_w.device)
        dq_w, dK_r = fold_bwd(dqp, q_w, r_kernel, si, ci)
        return dqu.to(ctx.q_u_dtype), dq_w, dk, dv, dK_r, None, None


def rel_flash_attention(q_u: torch.Tensor, q_w: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        r_kernel: torch.Tensor, lengths: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Rel-pos flash attention in the module's layout: q_u = q + u, q_w =
    q + w, k, v (B, T, H, Dh), r_kernel (D, H, Dh), lengths (B,); returns
    the context (B, T, H, Dh): the kernels for CUDA tensors, the plain
    versions for CPU ones; differentiable in q_u, q_w, k, v and
    r_kernel."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q_u, q_w, k, v, r_kernel)):
        return _RelFlashAttention.apply(q_u, q_w, k, v, r_kernel, lengths,
                                        float(sm_scale))
    qu, qp, kk, kp = _operands(q_u, q_w, k, r_kernel)
    return relpos_attention(qu, qp, kk, kp, v.contiguous(), lengths,
                            sm_scale)


def rel_flash_attention_plain(q_u, q_w, k, v, r_kernel, lengths,
                              sm_scale: float):
    """:func:`rel_flash_attention` through the plain version on any
    device: (context (B, T, H, Dh), lse (B, H, T))."""
    qu, qp, kk, kp = _operands(q_u, q_w, k, r_kernel)
    return relpos_attention_plain(qu, qp, kk, kp, v, lengths, sm_scale)
