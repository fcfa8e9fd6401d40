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
inputs, bf16 ones 16-byte aligned) or raises on anything they do not
take. There is no other fallback. bf16 runs on the tensor cores and
rounds where JAX's stock TPU kernels round: the weights before P.V in the
forward (normalised up to 128 keys, against the running maximum of
128-key blocks past that, see :func:`flash_attention_plain`), p^T, ds^T
and ds before the backward's products. The plain versions do the same with
``round_weights=True``, which the card's checks use, each output element
within :func:`flash_attention_bound` or :func:`flash_attention_bwd_bound`,
bounds built from that element's own terms; off (the default, and the
CPU path) they keep fp32 math throughout, as ``_attend`` does, the JAX
package's path off the TPU. fp32 runs on the CUDA cores. ``LAUNCHES``
counts launches of the forward kernel, ``BWD_DQ_LAUNCHES`` and
``BWD_DKV_LAUNCHES`` those of the two backward kernels.

Without a gradient the forward is the ``torch.library`` custom op
``openseq2seq_tpu_torch::flash_attn_fwd`` (:func:`flash_attn_fwd`), so
that ``torch.export`` traces it as one node with a fake implementation
instead of reaching the ``ctypes`` launch, and a reloaded program
launches the kernel through it (``serving/``).
"""
from __future__ import annotations

import ctypes
import re
from typing import Optional, Tuple

import torch

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
HEAD_DIMS = (64, 128, 256)
MASKED = -1e9
# a bf16 value and its neighbour differ by at most this fraction of it
# (8 significant bits)
BF16_ULP = 2.0 ** -7
# entry point -> (library, pointer arguments)
_ENTRY = {"flash_attn_fwd": (KERNEL, 6), "flash_attn_bwd_dq": (BWD_KERNEL, 9),
          "flash_attn_bwd_dkv": (BWD_KERNEL, 9)}
_fns = {}


def _round_block() -> int:
    """The keys of one rounding block of the bf16 forward kernels,
    ``kRoundBlock`` in ``csrc/mma_sync.cuh``."""
    from ..kernels.build import CSRC_DIR
    text = (CSRC_DIR / "mma_sync.cuh").read_text()
    return int(re.search(r"constexpr int kRoundBlock = (\d+);",
                         text).group(1))


# keys of one rounding block, the key block of JAX's TPU kernels (128):
# up to this many keys the stock kernel normalises the weights before it
# rounds them; past it the running maximum moves once a block
ROUND_BLOCK = _round_block()


def block_weights(logits: torch.Tensor, dtype: torch.dtype,
                  block: int = ROUND_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights of fp32 scores ``logits`` (..., Tk) rounded to ``dtype``
    as a flash kernel over ``block``-key blocks rounds them: p = exp(s -
    m_j), m_j the running maximum after key block j, rounded, then
    brought to the row's final maximum m by the fp32 factor exp(m_j - m).
    Returns those weights and l, the sum of the unrounded p brought to m
    the same way, both fp32: the output is (weights . v) / l, as the TPU
    kernels' multi-step variants compute it
    (``openseq2seq_tpu/ops/flash_relpos.py:95-113``)."""
    Tk = logits.shape[-1]
    n_blocks = -(-Tk // block)
    padded = torch.nn.functional.pad(logits, (0, n_blocks * block - Tk),
                                     value=-float("inf"))
    m_run = torch.cummax(padded.unflatten(-1, (n_blocks, block)).amax(-1),
                         dim=-1).values
    m_key = m_run.repeat_interleave(block, dim=-1)[..., :Tk]
    p = torch.exp(logits - m_key)
    to_final = torch.exp(m_key - m_run[..., -1:])
    return p.to(dtype).float() * to_final, \
        (p * to_final).sum(-1, keepdim=True)


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
                          return_lse: bool = False,
                          round_weights: bool = False):
    """The plain version: fp32 scores, the mask as an additive -1e9,
    softmax, then the weighted sum of v in fp32; output in q's dtype.
    With ``return_lse`` also the rows' log-sum-exp (B, H, Tq), fp32.
    With ``round_weights`` the weights are rounded to v's dtype before the
    weighted sum where JAX's stock kernel behind the JAX package's
    ``_attend_flash`` rounds them, as the bf16 kernel does: up to
    ``ROUND_BLOCK`` keys, its key block, normalised first, o = round(p /
    l) v (the stock kernel's single step, ``flash_attention.py:547,
    :556``); past it p = exp(s - m) rounded against the running maximum
    of each block, o = (round(p) v) * (1 / l) with l the sum of the
    unrounded p (its multi-step variant, ``:471``; see
    :func:`block_weights`)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits, off = _scores(q, k, kv_valid, causal, sm_scale)
    if round_weights and k.shape[1] <= ROUND_BLOCK:
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        out = torch.einsum("bhqk,bkhd->bqhd",
                           (p / p.sum(-1, keepdim=True)).to(
                               v.dtype).float(), v.float()).to(q.dtype)
    elif round_weights:
        w, l = block_weights(logits, v.dtype)
        inv_l = 1.0 / l.transpose(1, 2)
        out = (torch.einsum("bhqk,bkhd->bqhd", w, v.float()) *
               inv_l).to(q.dtype)
    else:
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights,
                           v.float()).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits - off, dim=-1)


def _score_error(q, k, p, sm_scale):
    """How far an fp32 p = exp(s - c) may sit from this module's: the
    scores' sums of D products in another order (2 D 2^-24 of their terms'
    sizes), and 2^-16 in the exponent for the exponential and the
    scaling."""
    qa, ka = q.float().abs(), k.float().abs()
    return p * (2.0 ** -23 * q.shape[-1] * sm_scale *
                torch.einsum("bqhd,bkhd->bhqk", qa, ka) + 2.0 ** -16)


def _sum_bound(grad, a, err_a, b, eq, n):
    """The bound of a bf16 ``grad`` = sum of a b over n terms against the
    same sum computed another way (a kernel), where a (fp32, within
    ``err_a``) is rounded to bf16 before the product and b is exact on
    both sides: one ulp of
    ``grad`` for its last rounding; for each term one ulp of the rounded a
    (it may round the other way) plus ``err_a``, times |b|; the fp32 sum in
    another order, 2 n 2^-24 of the terms' sizes; and (1 + ``BF16_ULP``)
    on the terms for their products with the last rounding."""
    a = a.to(torch.bfloat16).float().abs()
    terms = torch.einsum(eq, (BF16_ULP + n * 2.0 ** -23) * a + err_a,
                         b.float().abs())
    return BF16_ULP * grad.float().abs() + (1 + BF16_ULP) * terms


def flash_attention_bound(q, k, v, kv_valid=None, causal=False,
                          sm_scale=None) -> torch.Tensor:
    """Element by element, how far a bf16 forward that rounds the weights
    before P.V may sit from ``flash_attention_plain(...,
    round_weights=True)`` on the same inputs; fp32, in the output's
    shape. Each element's bound is built from its own terms w v: one ulp of
    each rounded weight w = p / l, which may round the other way (one side
    normalises before it rounds, or rounds against a running maximum,
    and the other not), plus w's fp32 error (the scores', and 2 Tk 2^-24
    for l's sum), see ``_sum_bound``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    want = flash_attention_plain(q, k, v, kv_valid, causal, sm_scale,
                                 round_weights=True)
    logits, _ = _scores(q, k, kv_valid, causal, sm_scale)
    w = torch.softmax(logits, dim=-1)
    Tk = k.shape[1]
    err_w = _score_error(q, k, w, sm_scale) + w * Tk * 2.0 ** -23
    return _sum_bound(want, w, err_w, v, "bhqk,bkhd->bqhd", Tk)


def _bwd_terms(q, k, v, o, lse, do, kv_valid, causal, sm_scale):
    """The backward's recompute in fp32: p from ``lse``, dP = dO v^T and
    ``di = rowsum(dO * O)``."""
    logits, off = _scores(q, k, kv_valid, causal, sm_scale)
    p = torch.exp((logits - off) - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    di = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    return p, dp, di


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid=None,
                              causal=False, sm_scale=None,
                              round_weights: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain version of the backward, the kernels' recompute written
    out in fp32: p from ``lse``, ``di = rowsum(dO * O)``,
    ``ds = p * (dO v^T - di)``; (dq, dk, dv) in the inputs' dtypes. With
    ``round_weights`` the products' operands are rounded to dO's dtype
    where JAX's stock TPU kernels round them: p^T for dv
    (``flash_attention.py:900``), ds^T = (p (dp - di) sm_scale)^T for dk
    (``:918``) and ds for dq (``:1251-1258``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p, dp, di = _bwd_terms(q, k, v, o, lse, do, kv_valid, causal, sm_scale)

    def rounded(x):
        return x.to(do.dtype).float() if round_weights else x
    ds = p * (dp - di)
    if round_weights:  # the stock kernels round ds with the scale applied
        ds, sm_scale = rounded(ds * sm_scale), 1.0
    dv = torch.einsum("bhqk,bqhd->bkhd", rounded(p), do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_bound(q, k, v, o, lse, do, kv_valid=None,
                              causal=False, sm_scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Element by element, how far the bf16 gradients of a backward that
    rounds where JAX's stock kernels round (p^T and ds to dO's dtype, sums
    in fp32) may sit from ``flash_attention_bwd_plain(...,
    round_weights=True)`` on the same inputs, o and lse; fp32, in the
    gradients' shapes. Each element's bound is built from its own terms
    a b, a = p for dv and ds for dq and dk (see ``_sum_bound``), so that it
    does not grow with another row's magnitude: a row of one valid key,
    whose dv sums dO over all queries, sets no other key's bound. a's fp32
    error: p's (``_score_error``), and for ds also dP's and di's sums of D
    products in another order (2 D 2^-24 of their terms' sizes each), so
    that a ds which cancels to 0 keeps room."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid,
                                           causal, sm_scale,
                                           round_weights=True)
    p, dp, di = _bwd_terms(q, k, v, o, lse, do, kv_valid, causal, sm_scale)
    err_p = _score_error(q, k, p, sm_scale)
    va, oa, doa = (x.float().abs() for x in (v, o, do))
    err_dp_di = 2.0 ** -23 * q.shape[-1] * (
        torch.einsum("bqhd,bkhd->bhqk", doa, va) +
        (doa * oa).sum(-1).transpose(1, 2)[..., None])
    ds = p * (dp - di) * sm_scale
    err_ds = (p * err_dp_di + err_p * (dp - di).abs()) * sm_scale
    Tq, Tk = q.shape[1], k.shape[1]
    return (_sum_bound(dq, ds, err_ds, k, "bhqk,bkhd->bqhd", Tk),
            _sum_bound(dk, ds, err_ds, q, "bhqk,bqhd->bkhd", Tq),
            _sum_bound(dv, p, err_p, do, "bhqk,bqhd->bkhd", Tq))


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


def _check_aligned(*tensors):
    """The bf16 kernels copy rows with 16-byte loads and stores."""
    for x in tensors:
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError("bf16 tensors must start on a 16-byte boundary; "
                             "got address {:#x}".format(x.data_ptr()))


def flash_attention_cuda(q, k, v, kv_valid=None, causal=False,
                         sm_scale=None, return_lse: bool = False):
    """Launch ``flash_attn_fwd``; with ``return_lse`` also the rows'
    log-sum-exp (B, H, Tq), fp32. Raises on what it does not take."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError("no flash attention kernel for device {}".format(
            q.device))
    _check(q, k, v, kv_valid)
    _check_aligned(q, k, v)
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
    _check_aligned(q, k, v, o, do)
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


@torch.library.custom_op("openseq2seq_tpu_torch::flash_attn_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], causal: bool,
                   sm_scale: float) -> torch.Tensor:
    """The forward as a ``torch.library`` custom op, so that a tracer
    (``torch.export``) records one node where the eager path launches the
    kernel: on CUDA :func:`flash_attention_cuda` (which counts
    ``LAUNCHES`` and raises on what it does not take), on the CPU
    :func:`flash_attention_plain`; its fake gives the output's shape and
    dtype. An exported program that holds the node launches the kernel
    wherever this module has been imported."""
    return flash_attention_cuda(q, k, v, kv_valid, causal, sm_scale)


@flash_attn_fwd.register_kernel("cpu")
def _flash_attn_fwd_cpu(q, k, v, kv_valid, causal, sm_scale):
    # contiguous, as the kernel writes it and the fake describes it
    return flash_attention_plain(q, k, v, kv_valid, causal,
                                 sm_scale).contiguous()


@flash_attn_fwd.register_fake
def _flash_attn_fwd_fake(q, k, v, kv_valid, causal, sm_scale):
    return q.new_empty(q.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale + mask) v, (B, T, H, D) in and out: the
    plain version for a CPU tensor, the kernels for a CUDA one;
    differentiable in q, k and v. Without a gradient it is the custom op
    :func:`flash_attn_fwd`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_valid, bool(causal),
                                     float(sm_scale))
    return flash_attn_fwd(q, k, v, kv_valid, bool(causal), float(sm_scale))
