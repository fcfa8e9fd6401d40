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
shared memory and, for the bf16 backward, at most nine 64-column chunks
of Dh + D, 576 at Dh = 64) or raise. There is no other fallback. The
bf16 forward rounds the weights where ``_fwd_kernel`` rounds them (against
the running maximum of 128-key blocks, see :func:`flash_attention_plain`),
the bf16 backward p and ds where ``_bwd_pallas`` does; the card holds them
to the plain versions within :func:`relpos_attention_bound` and
:func:`relpos_attention_bwd_bound`, bounds built from each element's own
terms.
``LAUNCHES`` counts launches of the forward kernel, ``BWD_DQ_LAUNCHES``
and ``BWD_DKV_LAUNCHES`` those of the two backward kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .flash_attention import _sum_bound, block_weights

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
# ``*_smem`` entries take (Dh, D, is_bf16) and return a byte count, the
# ``*_ctas_per_sm`` ones ([dq,] Dh, D) and return a CTA count
_ENTRY = {"flash_relpos_fwd": (KERNEL, 8, 6),
          "flash_relpos_bwd_dq": (BWD_KERNEL, 12, 6),
          "flash_relpos_bwd_dkv": (BWD_KERNEL, 11, 6)}
_fns = {}


def _kernel(entry: str = KERNEL):
    fn = _fns.get(entry)
    if fn is None:
        from ..kernels import build
        lib = BWD_KERNEL if entry.startswith(BWD_KERNEL) else KERNEL
        fn = getattr(build.load(lib), entry)
        if entry in _ENTRY:
            _, n_ptr, n_int = _ENTRY[entry]
            fn.argtypes = [ctypes.c_void_p] * n_ptr + \
                [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        elif entry.endswith("_ctas_per_sm"):
            fn.argtypes = [ctypes.c_int] * (3 if lib == BWD_KERNEL else 2)
            fn.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_longlong
        _fns[entry] = fn
    return fn


def ctas_per_sm(kernel: str, Dh: int, D: int) -> int:
    """The CTAs of the bf16 kernel ``kernel`` ("fwd", "dq" or "dkv") for
    (Dh, D) that one SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if kernel == "fwd":
        n = _kernel("flash_relpos_fwd_ctas_per_sm")(Dh, D)
    else:
        n = _kernel("flash_relpos_bwd_ctas_per_sm")(int(kernel == "dq"),
                                                     Dh, D)
    if n < 0:
        raise RuntimeError("occupancy of the {} kernel: CUDA error {}"
                           .format(kernel, -n))
    return n


@functools.lru_cache(maxsize=None)
def _angles_np(T: int, dim: int):
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
    ang_i = (np.arange(T) + T - 1)[:, None] * inv_freq[None, :]
    ang_j = np.arange(T)[:, None] * inv_freq[None, :]
    return (np.sin(ang_i).astype(np.float32), np.cos(ang_i).astype(np.float32),
            np.concatenate([np.cos(ang_j), np.sin(ang_j)],
                           axis=1).astype(np.float32))


def _angle_tensors(T: int, dim: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in _angles_np(T, dim))


_cached_angles = functools.lru_cache(maxsize=64)(_angle_tensors)


def angles(T: int, dim: int, device="cpu"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(si, ci, k_pos) on ``device``, fp32: the query angles' sines and
    cosines (T, dim / 2) and the key table [cos | sin] (T, dim), computed
    in float64 with numpy and rounded at the end, as ``_angles`` does.
    Cached, but not under a tracer (``torch.export``): its tensors are
    fake and would outlive the trace in the cache."""
    if torch.compiler.is_compiling():
        return _angle_tensors(T, dim, device)
    return _cached_angles(T, dim, device)


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


def _masked_scores(q, k, lengths, sm_scale):
    """fp32 scaled scores q~ k~^T (B, H, T, T), keys t >= max(length, 1)
    replaced by -1e30."""
    T = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(min=1)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, sm_scale: float,
                          round_weights: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain attention over q~, k~ (B, H, T, dqk) and v (B, H, T, dv):
    fp32 scores, keys t >= max(length, 1) replaced by -1e30, softmax.
    With ``round_weights`` (the default) the weights are rounded to v's
    dtype where the TPU kernel ``_fwd_kernel`` rounds them: p = exp(s -
    m) against the running maximum m of its 128-key blocks, l summing the
    unrounded p, the output divided by l (:func:`block_weights`); without
    it, or in fp32, nothing is rounded but the output. Returns o (B, H, T,
    dv) in q's dtype and lse (B, H, T), fp32."""
    s = _masked_scores(q, k, lengths, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    if round_weights and v.dtype != torch.float32:
        w, l = block_weights(s, v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v.float()) / l
    else:
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                         v.float())
    return o.to(q.dtype), lse


def relpos_attention_plain(qu, qp, k, kp, v, lengths, sm_scale,
                           round_weights: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version on the kernel's inputs: qu, k, v
    (B, T, H, Dh), qp (B, H, T, D), kp (T, D). Returns the context
    (B, T, H, Dh) and lse (B, H, T); ``round_weights`` as
    :func:`flash_attention_plain` takes it."""
    q_aug, k_aug = _augmented(qu, qp, k, kp)
    o, lse = flash_attention_plain(q_aug, k_aug, v.transpose(1, 2),
                                   lengths, sm_scale, round_weights)
    return o.transpose(1, 2).contiguous(), lse


def _augmented(qu, qp, k, kp):
    """q~ and k~ (B, H, T, Dh + D) from the kernel's inputs."""
    B, T, H, _ = k.shape
    return (torch.cat([qu.transpose(1, 2), qp], dim=-1),
            torch.cat([k.transpose(1, 2),
                       kp.expand(B, H, T, kp.shape[-1])], dim=-1))


def _bwd_terms(qu, qp, k, kp, v, lengths, o, lse, do, sm_scale):
    """The backward's recompute in fp32, (B, H, T, .) layouts: q~, k~, p
    = exp(s - lse) over the valid keys (0 elsewhere), dO, dP = dO v^T and
    delta = rowsum(dO * O)."""
    q_aug, k_aug = (x.float() for x in _augmented(qu, qp, k, kp))
    p = torch.exp(_masked_scores(q_aug, k_aug, lengths, sm_scale) -
                  lse[..., None])
    do_t = do.transpose(1, 2).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do_t, v.transpose(1, 2).float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    return q_aug, k_aug, p, do_t, dp, delta


def _split_grads(dq, dk, dv, Dh):
    """(B, H, T, .) gradients -> dqu (B, T, H, Dh), dqp (B, H, T, D), dk,
    dv (B, T, H, Dh)."""
    return (dq[..., :Dh].transpose(1, 2).contiguous(),
            dq[..., Dh:].contiguous(), dk.transpose(1, 2).contiguous(),
            dv.transpose(1, 2).contiguous())


def relpos_attention_bwd_plain(qu, qp, k, kp, v, lengths, o, lse, do,
                               sm_scale):
    """The backward kernels' plain version on the kernel's inputs (as
    :func:`relpos_attention_plain` takes them), the forward's context o
    and lse (B, H, T), and the context's cotangent do (B, T, H, Dh), at
    ``_bwd_pallas``'s precision: p = exp(s - lse) over the valid keys,
    rounded to do's dtype for dv = p^T dO; ds = p (dP - delta) * scale
    rounded to q's dtype for dk = ds^T q~[:, :Dh] and dq~ = ds k~; sums in
    fp32. Returns dqu (B, T, H, Dh), dqp (B, H, T, D), dk and dv (B, T, H,
    Dh) in the inputs' dtype."""
    Dh = k.shape[-1]
    q_aug, k_aug, p, do_t, dp, delta = _bwd_terms(qu, qp, k, kp, v, lengths,
                                                  o, lse, do, sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do_t)
    ds = (p * (dp - delta) * sm_scale).to(qu.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q_aug[..., :Dh])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k_aug)
    return _split_grads(dq.to(qu.dtype), dk.to(k.dtype), dv.to(v.dtype), Dh)


def _score_error(q_aug, k_aug, p, sm_scale):
    """How far an fp32 p = exp(s - c) may sit from this module's: the
    scores' sums of Dh + D products in another order (2 (Dh + D) 2^-24 of
    their terms' sizes), and 2^-16 in the exponent for the exponential
    and the scaling."""
    return p * (2.0 ** -23 * q_aug.shape[-1] * sm_scale * torch.einsum(
        "bhqd,bhkd->bhqk", q_aug.abs(), k_aug.abs()) + 2.0 ** -16)


def relpos_attention_bound(qu, qp, k, kp, v, lengths, sm_scale
                           ) -> torch.Tensor:
    """Element by element, how far a bf16 forward that rounds the weights
    as ``_fwd_kernel`` does may sit from ``relpos_attention_plain`` (which
    rounds them so) on the same inputs; fp32, in the context's shape (B,
    T, H, Dh). Each element's bound is built from its own terms w v: one
    ulp of each rounded weight w = p / l, which may round the other way
    from fp32 values computed in another order, plus w's fp32 error (the
    scores', and 2 T 2^-24 for l's sum), see ``_sum_bound``."""
    want, _ = relpos_attention_plain(qu, qp, k, kp, v, lengths, sm_scale)
    q_aug, k_aug = (x.float() for x in _augmented(qu, qp, k, kp))
    w = torch.softmax(_masked_scores(q_aug, k_aug, lengths, sm_scale), -1)
    T = k.shape[1]
    err_w = _score_error(q_aug, k_aug, w, sm_scale) + w * T * 2.0 ** -23
    return _sum_bound(want, w, err_w, v, "bhqk,bkhd->bqhd", T)


def relpos_attention_bwd_bound(qu, qp, k, kp, v, lengths, o, lse, do,
                               sm_scale):
    """Element by element, how far the bf16 gradients of a backward that
    rounds where ``_bwd_pallas`` rounds (p to dO's dtype for dv, ds to q's
    for dk and dq~, sums in fp32) may sit from
    ``relpos_attention_bwd_plain`` on the same inputs, o and lse; fp32, in
    the shapes of (dqu, dqp, dk, dv). Each element's bound is built from
    its own terms a b, a = p for dv and ds for dq~ and dk (see
    ``_sum_bound``), so that a key of a one-key row, whose dv sums dO over
    all queries, sets no other element's bound. a's fp32 error: p's
    (``_score_error``), and for ds also dP's and delta's sums of Dh
    products in another order (2 Dh 2^-24 of their terms' sizes each), so
    that a ds which cancels to 0 keeps room."""
    Dh, T = k.shape[-1], k.shape[1]
    dqu, dqp, dk, dv = relpos_attention_bwd_plain(qu, qp, k, kp, v, lengths,
                                                  o, lse, do, sm_scale)
    q_aug, k_aug, p, do_t, dp, delta = _bwd_terms(qu, qp, k, kp, v, lengths,
                                                  o, lse, do, sm_scale)
    err_p = _score_error(q_aug, k_aug, p, sm_scale)
    va = v.transpose(1, 2).float().abs()
    err_dp_delta = 2.0 ** -23 * Dh * (
        torch.einsum("bhqd,bhkd->bhqk", do_t.abs(), va) +
        (do.float().abs() * o.float().abs()).sum(-1).transpose(1, 2)[
            ..., None])
    ds = p * (dp - delta) * sm_scale
    err_ds = (p * err_dp_delta + err_p * (dp - delta).abs()) * sm_scale
    dq = torch.cat([dqu.transpose(1, 2), dqp], dim=-1)
    return _split_grads(
        _sum_bound(dq, ds, err_ds, k_aug, "bhqk,bhkd->bhqd", T),
        _sum_bound(dk.transpose(1, 2), ds, err_ds, q_aug[..., :Dh],
                   "bhqk,bhqd->bhkd", T),
        _sum_bound(dv.transpose(1, 2), p, err_p, do_t, "bhqk,bhqd->bhkd", T),
        Dh)


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
