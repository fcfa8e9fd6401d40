"""The GRU recurrence on the hand-written CUDA kernels
``csrc/gru_scan_fwd.cu`` and ``csrc/gru_scan_bwd.cu`` (port of
``openseq2seq_tpu/ops/gru_pallas.py``, kernel B4, forward and backward).

:func:`gru_scan` runs the cuDNN-variant GRU over pre-projected inputs
x_proj (B, T, 3H), gates blocked [r | z | n], with W_h (H, 3H), the fp32
recurrent bias b_h (3H,), h0 (B, H) and int32 lengths (B,). It returns
ys (B, T, H), zero past each row's length (the layer's output mask,
applied by the kernel), and h_last (B, H); with ``residuals`` also
(acts (B, T, 3H) = [r, z, n], hn (B, T, H) = the H-side candidate term),
what the backward needs, at the original time index.
``reverse`` walks t from T - 1 down to 0 with the mask t < length: the
JAX package's flip, suffix mask and flip back, without flipped copies.

The numbers are the TPU kernels', not the ``lax.scan``'s: the products
h W_h accumulate in fp32 from the compute-type h and W_h (no rounding
before the bias), the gates run in fp32, and h is rounded to the compute
type as it is carried. :func:`gru_scan_plain` is that arithmetic in
PyTorch, step by step, and :func:`gru_scan_bwd_plain` the backward
kernel's, which rounds the gate cotangents to the compute type as the
TPU kernel does (``gru_pallas.py:178-184``).

When autograd will differentiate the call, :func:`gru_scan` is one
``torch.autograd.Function`` on every device: on CUDA tensors its
forward launches ``gru_scan_fwd`` with the residuals (``LAUNCHES``
counts it) and its backward ``gru_scan_bwd`` (``BWD_LAUNCHES``); on CPU
tensors the two plain versions run in their place, so the CPU gives the
JAX ``custom_vjp``'s numbers. dW_h and db_h come from products over all
steps outside the kernel, as the JAX VJP leaves them to XLA
(``gru_pallas.py:279-292``). Without gradients (eval, infer) the forward
alone runs, with no residuals. Anything the kernels do not take raises
ValueError before any launch (``rnn_scan.check_inputs``,
``rnn_scan.check_fits``); there is no fallback.

:func:`supported` is the JAX package's gate (``gru_pallas.supported``)
without its backend test, with ``_pick_bblk``'s VMEM budget kept as it
is, so that a layer takes the fused path where the JAX package's does;
and in fp32 also at H 64, at any B, which the TPU kernel's blocks refuse
and the CUDA kernels take (64 CTAs of one unit: ``rnn_scan.units_per_cta``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rnn_scan

LAUNCHES = 0
KERNEL = "gru_scan_fwd"
BWD_LAUNCHES = 0
BWD_KERNEL = "gru_scan_bwd"

_BUDGET = 11 * 1024 * 1024


def _pick_bblk(B: int, H: int) -> int:
    wh = H * 3 * H * 2
    for bblk in sorted({d for d in range(1, B + 1) if B % d == 0},
                       reverse=True):
        streams = bblk * 3 * H * 2 * 2 + bblk * H * 2 * 4
        if wh + 2 * streams + bblk * H * 8 <= _BUDGET:
            return bblk
    return 0


def supported(B: int, T: int, H: int, dtype: torch.dtype) -> bool:
    if not rnn_scan.takes(H, dtype):
        return False
    if H == rnn_scan.NARROW_FP32:
        return B > 0
    if B < 8:
        return False
    bblk = _pick_bblk(B, H)
    return bblk != 0 and bblk % 8 == 0


def gru_scan_plain(x_proj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                   h0: torch.Tensor, lengths: torch.Tensor,
                   reverse: bool = False, residuals: bool = False):
    """The kernel's arithmetic, one step at a time; same arguments and
    results as :func:`gru_scan`."""
    B, T, H3 = x_proj.shape
    H = H3 // 3
    dt = x_proj.dtype
    w = wh.to(dt).float()
    b = bh.float()
    h = h0.to(dt)
    ys, acts, hns = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hp = h.float() @ w + b
        xp = x_proj[:, t].float()
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
        hn = hp[:, 2 * H:]
        n = torch.tanh(xp[:, 2 * H:] + r * hn)
        h32 = h.float()
        live = (t < lengths)[:, None]
        h = torch.where(live, (1.0 - z) * n + z * h32, h32).to(dt)
        ys[t] = torch.where(live, h, 0.0)
        if residuals:
            acts[t] = torch.cat([r, z, n], dim=1).to(dt)
            hns[t] = hn.to(dt)
    ys = rnn_scan.stack_steps(ys, (B, 0, H), x_proj)
    if not residuals:
        return ys, h
    return ys, h, (rnn_scan.stack_steps(acts, (B, 0, H3), x_proj),
                   rnn_scan.stack_steps(hns, (B, 0, H), x_proj))


def gru_scan_bwd_plain(wh: torch.Tensor, h0: torch.Tensor,
                       lengths: torch.Tensor, ys: torch.Tensor,
                       acts: torch.Tensor, hn: torch.Tensor,
                       dys: torch.Tensor, dh_last: torch.Tensor,
                       reverse: bool = False, carries: bool = False):
    """The backward kernel's arithmetic, one step at a time, from the
    forward's ys and residuals: (dx_proj (B, T, 3H), dh0 (B, H)), both in
    the compute type; with ``carries`` also the fp32 dh carried into each
    step (B, T, H), before its ys cotangent is added. ``dys`` past each
    length is dropped (ys is the constant 0 there)."""
    B, T, H3 = acts.shape
    H = H3 // 3
    dt = acts.dtype
    w = wh.to(dt).float()
    h_prev = rnn_scan.prev_states(ys, h0, lengths, reverse)
    dh = dh_last.float()
    dx, seen = [None] * T, [None] * T
    for t in rnn_scan.backward_steps(T, reverse):
        live = (t < lengths)[:, None]
        a = acts[:, t].float()
        r, z, n = a[:, :H], a[:, H:2 * H], a[:, 2 * H:]
        seen[t] = dh
        dh = dh + torch.where(live, dys[:, t].float(), 0.0)
        dh_new = torch.where(live, dh, 0.0)
        dz = dh_new * (h_prev[:, t].float() - n)
        dn = dh_new * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn[:, t].float() * r * (1.0 - r)
        dzp = dz * z * (1.0 - z)
        dx[t] = torch.cat([dr, dzp, dn], dim=1).to(dt)
        dhp = torch.cat([dr, dzp, dn * r], dim=1).to(dt).float()
        dh = torch.where(live, 0.0, dh) + dh_new * z + dhp @ w.t()
    out = rnn_scan.stack_steps(dx, (B, 0, H3), acts), dh.to(dt)
    if carries:
        out += (rnn_scan.stack_steps(seen, (B, 0, H), dh),)
    return out


def _fwd_cuda(x_proj, wh, bh, h0, lengths, reverse, residuals):
    """Launch ``gru_scan_fwd``; returns ys, h_last (and acts, hn)."""
    global LAUNCHES
    rnn_scan.check_inputs(x_proj, wh, h0, lengths, 3)
    B, T, H3 = x_proj.shape
    H = H3 // 3
    if tuple(bh.shape) != (H3,) or bh.device != x_proj.device:
        raise ValueError("bh must be ({},) on {}, got {} on {}".format(
            H3, x_proj.device, tuple(bh.shape), bh.device))
    dt, dev = x_proj.dtype, x_proj.device
    rnn_scan.check_fits(KERNEL, H, dt, dev)
    hbuf = torch.empty((2, B, H), dtype=dt, device=dev)
    hbuf[0].copy_(h0)
    ys = torch.empty((B, T, H), dtype=dt, device=dev)
    h_last = hbuf[0].clone()
    res = (torch.empty((B, T, H3), dtype=dt, device=dev),
           torch.empty((B, T, H), dtype=dt, device=dev)) if residuals \
        else (None, None)
    if B and T:
        rnn_scan.launch(KERNEL, (
            x_proj.contiguous(), wh.to(dt).contiguous(),
            bh.float().contiguous(), lengths.int().contiguous(), hbuf, ys,
            h_last, *res, torch.zeros(1, dtype=torch.int32, device=dev)),
            (B, T, H, rnn_scan.units_per_cta(H), int(reverse),
             int(dt == torch.bfloat16)))
        LAUNCHES += 1
    return (ys, h_last) + (res if residuals else ())


def _bwd_cuda(wh, h0, lengths, ys, acts, hn, dys, dh_last, reverse,
              carries=False):
    """Launch ``gru_scan_bwd``; same arguments and results as
    :func:`gru_scan_bwd_plain`."""
    global BWD_LAUNCHES
    B, T, H3 = acts.shape
    H = H3 // 3
    dt, dev = acts.dtype, acts.device
    rnn_scan.check_fits(BWD_KERNEL, H, dt, dev)
    hcarry = dh_last.float().contiguous().clone()
    dx = torch.empty((B, T, H3), dtype=dt, device=dev)
    seen = torch.empty((B, T, H), device=dev) if carries else None
    if not (B and T):
        return (dx, hcarry.to(dt)) + ((seen,) if carries else ())
    dh0 = torch.empty((B, H), dtype=dt, device=dev)
    rnn_scan.launch(BWD_KERNEL, (
        wh.to(dt).contiguous(), acts.contiguous(), hn.contiguous(),
        ys.contiguous(), h0.to(dt).contiguous(), lengths.int().contiguous(),
        dys.to(dt).contiguous(), hcarry, dx,
        torch.empty((2, B, H3), dtype=dt, device=dev), dh0, seen,
        torch.zeros(1, dtype=torch.int32, device=dev)),
        (B, T, H, rnn_scan.units_per_cta(H), int(reverse),
         int(dt == torch.bfloat16)))
    BWD_LAUNCHES += 1
    return (dx, dh0) + ((seen,) if carries else ())


def _forward(x_proj, wh, bh, h0, lengths, reverse, residuals):
    """The kernel on CUDA tensors, the plain version on CPU tensors: the
    flat (ys, h_last[, acts, hn])."""
    if x_proj.device.type == "cpu":
        out = gru_scan_plain(x_proj, wh, bh, h0, lengths, reverse,
                             residuals)
        return out[:2] + (tuple(out[2]) if residuals else ())
    return _fwd_cuda(x_proj, wh, bh, h0, lengths, reverse, residuals)


class _GRUScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, wh, bh, h0, lengths, reverse):
        ys, h_last, acts, hn = _forward(x_proj, wh, bh, h0, lengths,
                                        reverse, True)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(wh, h0, lengths, ys, acts, hn)
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dh_last):
        wh, h0, lengths, ys, acts, hn = ctx.saved_tensors
        dt = acts.dtype
        H = acts.shape[2] // 3
        # BiRNN discards the last states: their cotangent arrives as None
        dys = torch.zeros_like(ys) if dys is None else dys
        dh_last = h0.new_zeros(h0.shape, dtype=dt) if dh_last is None \
            else dh_last
        bwd = gru_scan_bwd_plain if acts.device.type == "cpu" else _bwd_cuda
        dx, dh0 = bwd(wh, h0, lengths, ys, acts, hn, dys, dh_last,
                      ctx.reverse)
        dwh = dbh = None
        need_wh, need_bh = ctx.needs_input_grad[1:3]
        if need_wh or need_bh:
            # dhp = dx with the candidate third scaled by r, in fp32
            dx32 = dx.float()
            dhp = torch.cat([dx32[..., :2 * H],
                             dx32[..., 2 * H:] * acts[..., :H].float()],
                            dim=-1).reshape(-1, 3 * H)
            if need_wh:
                h_prev = rnn_scan.prev_states(ys, h0, lengths, ctx.reverse)
                dwh = (h_prev.reshape(-1, H).float().t() @ dhp).to(dt).to(
                    wh.dtype)
            if need_bh:
                dbh = dhp.sum(dim=0)
        return dx, dwh, dbh, dh0.to(h0.dtype), None, None


def gru_scan(x_proj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
             h0: torch.Tensor, lengths: torch.Tensor, reverse: bool = False,
             residuals: bool = False) -> Tuple:
    """(ys, h_last), differentiable; or, with ``residuals`` and outside
    autograd, (ys, h_last, (acts, hn))."""
    if not residuals and rnn_scan.needs_grad(x_proj, wh, bh, h0):
        return _GRUScan.apply(x_proj, wh, bh, h0, lengths, reverse)
    with torch.no_grad():
        out = _forward(x_proj, wh, bh, h0, lengths, reverse, residuals)
    return (out[0], out[1], tuple(out[2:])) if residuals else tuple(out)
