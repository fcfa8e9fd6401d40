"""The LSTM recurrence on the hand-written CUDA kernels
``csrc/lstm_scan_fwd.cu`` and ``csrc/lstm_scan_bwd.cu`` (port of
``openseq2seq_tpu/ops/lstm_pallas.py``, kernel B3, forward and backward).

:func:`lstm_scan` runs the LSTM over pre-projected inputs x_proj
(B, T, 4H), gates blocked [i | f | g | o], with W_h (H, 4H) (no recurrent
bias), h0 (B, H), the fp32 cell state c0 (B, H), int32 lengths (B,) and
the forget bias added inside the forget gate's sigmoid. It returns ys
(B, T, H), zero past each row's length (the layer's output mask, applied
by the kernel), and (h_last, c_last), c_last in fp32; with ``residuals``
also (acts (B, T, 4H) = [i, f, tanh(g), o], cs (B, T, H) = the unmasked
fp32 cell state of each step), what the backward needs, at the original
time index. ``reverse`` walks t from T - 1 down to 0 with the mask
t < length, as ``ops/gru_scan.py`` does.

The numbers are the TPU kernels', not the ``lax.scan``'s: x_proj + h W_h
is formed in fp32 from the compute-type h and W_h with fp32 accumulation
(the scan rounds the sum to the compute type first), h is rounded to the
compute type as it is carried and c stays fp32. :func:`lstm_scan_plain`
is that arithmetic in PyTorch, step by step, and
:func:`lstm_scan_bwd_plain` the backward kernel's (dgates rounded to the
compute type and used rounded, ``lstm_pallas.py:205-216``), with one
repair: the cell state before a reverse row's first valid step is c0,
where the TPU kernel reads the unmasked c of the padded step beside it
(C15 in ROADMAP.md).

When autograd will differentiate the call, :func:`lstm_scan` is one
``torch.autograd.Function`` on every device: on CUDA tensors its
forward launches ``lstm_scan_fwd`` with the residuals (``LAUNCHES``) and
its backward ``lstm_scan_bwd`` (``BWD_LAUNCHES``); on CPU tensors the
two plain versions run in their place. dW_h = h_prev^T dgates is one
product over all steps outside the kernel (``lstm_pallas.py:329-334``).
Without gradients the forward alone runs, with no residuals. Anything
the kernels do not take raises ValueError before any launch (the fp32
forward and backward at H = 1280, whose fp32 copy of W_h does not fit a
CTA's shared memory, among them); there is no fallback.

:func:`supported` is the JAX package's gate (``lstm_pallas.supported``)
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
KERNEL = "lstm_scan_fwd"
BWD_LAUNCHES = 0
BWD_KERNEL = "lstm_scan_bwd"

_BUDGET = 11 * 1024 * 1024


def _pick_bblk(B: int, H: int) -> int:
    wh = H * 4 * H * 2
    for bblk in sorted({d for d in range(1, B + 1) if B % d == 0},
                       reverse=True):
        streams = bblk * 4 * H * 2 * 2 + bblk * H * (2 * 4 + 4)
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


def lstm_scan_plain(x_proj: torch.Tensor, wh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor,
                    lengths: torch.Tensor, forget_bias: float = 1.0,
                    reverse: bool = False, residuals: bool = False):
    """The kernel's arithmetic, one step at a time; same arguments and
    results as :func:`lstm_scan`."""
    B, T, H4 = x_proj.shape
    H = H4 // 4
    dt = x_proj.dtype
    w = wh.to(dt).float()
    h, c = h0.to(dt), c0.float()
    ys, acts, cs = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t].float() + h.float() @ w
        si = torch.sigmoid(gates[:, :H])
        sf = torch.sigmoid(gates[:, H:2 * H] + forget_bias)
        tg = torch.tanh(gates[:, 2 * H:3 * H])
        so = torch.sigmoid(gates[:, 3 * H:])
        c_new = sf * c + si * tg
        live = (t < lengths)[:, None]
        h = torch.where(live, so * torch.tanh(c_new), h.float()).to(dt)
        c = torch.where(live, c_new, c)
        ys[t] = torch.where(live, h, 0.0)
        if residuals:
            acts[t] = torch.cat([si, sf, tg, so], dim=1).to(dt)
            cs[t] = c_new
    ys = rnn_scan.stack_steps(ys, (B, 0, H), x_proj)
    if not residuals:
        return ys, (h, c)
    return ys, (h, c), (rnn_scan.stack_steps(acts, (B, 0, H4), x_proj),
                        rnn_scan.stack_steps(cs, (B, 0, H), c))


def lstm_scan_bwd_plain(wh: torch.Tensor, c0: torch.Tensor,
                        lengths: torch.Tensor, acts: torch.Tensor,
                        cs: torch.Tensor, dys: torch.Tensor,
                        dh_last: torch.Tensor, dc_last: torch.Tensor,
                        reverse: bool = False, carries: bool = False):
    """The backward kernel's arithmetic, one step at a time, from the
    forward's residuals: (dgates = dx_proj (B, T, 4H) and dh0 (B, H) in
    the compute type, dc0 (B, H) in fp32); with ``carries`` also the fp32
    dh and dc carried into each step (B, T, H) each, dh before its ys
    cotangent is added. ``dys`` past each length is dropped (ys is the
    constant 0 there)."""
    B, T, H4 = acts.shape
    H = H4 // 4
    dt = acts.dtype
    w = wh.to(dt).float()
    c_prev = rnn_scan.prev_states(cs, c0.float(), lengths, reverse)
    dh, dc = dh_last.float(), dc_last.float()
    dgates, seen_h, seen_c = [None] * T, [None] * T, [None] * T
    for t in rnn_scan.backward_steps(T, reverse):
        live = (t < lengths)[:, None]
        a = acts[:, t].float()
        si, sf, tg, so = a[:, :H], a[:, H:2 * H], a[:, 2 * H:3 * H], \
            a[:, 3 * H:]
        seen_h[t], seen_c[t] = dh, dc
        dh = dh + torch.where(live, dys[:, t].float(), 0.0)
        dh_new = torch.where(live, dh, 0.0)
        tc = torch.tanh(cs[:, t])
        dc_new = torch.where(live, dc, 0.0) + dh_new * so * (1.0 - tc * tc)
        dg = torch.cat([dc_new * tg * si * (1.0 - si),
                        dc_new * c_prev[:, t] * sf * (1.0 - sf),
                        dc_new * si * (1.0 - tg * tg),
                        dh_new * tc * so * (1.0 - so)], dim=1).to(dt)
        dgates[t] = dg
        dh = torch.where(live, 0.0, dh) + dg.float() @ w.t()
        dc = torch.where(live, 0.0, dc) + dc_new * sf
    out = rnn_scan.stack_steps(dgates, (B, 0, H4), acts), dh.to(dt), dc
    if carries:
        out += tuple(rnn_scan.stack_steps(s, (B, 0, H), dc)
                     for s in (seen_h, seen_c))
    return out


def _fwd_cuda(x_proj, wh, h0, c0, lengths, forget_bias, reverse, residuals):
    """Launch ``lstm_scan_fwd``; returns ys, h_last, c_last (and acts,
    cs)."""
    global LAUNCHES
    rnn_scan.check_inputs(x_proj, wh, h0, lengths, 4)
    B, T, H4 = x_proj.shape
    H = H4 // 4
    if tuple(c0.shape) != (B, H) or c0.device != x_proj.device:
        raise ValueError("c0 must be ({}, {}) on {}, got {} on {}".format(
            B, H, x_proj.device, tuple(c0.shape), c0.device))
    dt, dev = x_proj.dtype, x_proj.device
    rnn_scan.check_fits(KERNEL, H, dt, dev)
    hbuf = torch.empty((2, B, H), dtype=dt, device=dev)
    hbuf[0].copy_(h0)
    c_last = c0.float().clone()
    ys = torch.empty((B, T, H), dtype=dt, device=dev)
    h_last = hbuf[0].clone()
    res = (torch.empty((B, T, H4), dtype=dt, device=dev),
           torch.empty((B, T, H), dtype=torch.float32, device=dev)) \
        if residuals else (None, None)
    if B and T:
        rnn_scan.launch(KERNEL, (
            x_proj.contiguous(), wh.to(dt).contiguous(),
            lengths.int().contiguous(), hbuf, c_last, ys, h_last, *res,
            torch.zeros(1, dtype=torch.int32, device=dev)),
            (B, T, H, rnn_scan.units_per_cta(H), int(reverse),
             int(dt == torch.bfloat16)),
            (float(forget_bias),))
        LAUNCHES += 1
    return (ys, h_last, c_last) + (res if residuals else ())


def _bwd_cuda(wh, c0, lengths, acts, cs, dys, dh_last, dc_last, reverse,
              carries=False):
    """Launch ``lstm_scan_bwd``; same arguments and results as
    :func:`lstm_scan_bwd_plain`."""
    global BWD_LAUNCHES
    B, T, H4 = acts.shape
    H = H4 // 4
    dt, dev = acts.dtype, acts.device
    rnn_scan.check_fits(BWD_KERNEL, H, dt, dev)
    hcarry = dh_last.float().contiguous().clone()
    ccarry = dc_last.float().contiguous().clone()
    dgates = torch.empty((B, T, H4), dtype=dt, device=dev)
    seen = tuple(torch.empty((B, T, H), device=dev) for _ in range(2)) \
        if carries else (None, None)
    if not (B and T):
        return (dgates, hcarry.to(dt), ccarry) + (seen if carries else ())
    dh0 = torch.empty((B, H), dtype=dt, device=dev)
    rnn_scan.launch(BWD_KERNEL, (
        wh.to(dt).contiguous(), acts.contiguous(), cs.contiguous(),
        c0.float().contiguous(), lengths.int().contiguous(),
        dys.to(dt).contiguous(), hcarry, ccarry, dgates, dh0, *seen,
        torch.zeros(1, dtype=torch.int32, device=dev)),
        (B, T, H, rnn_scan.units_per_cta(H), int(reverse),
         int(dt == torch.bfloat16)))
    BWD_LAUNCHES += 1
    return (dgates, dh0, ccarry) + (seen if carries else ())


def _forward(x_proj, wh, h0, c0, lengths, forget_bias, reverse, residuals):
    """The kernel on CUDA tensors, the plain version on CPU tensors: the
    flat (ys, h_last, c_last[, acts, cs])."""
    if x_proj.device.type == "cpu":
        out = lstm_scan_plain(x_proj, wh, h0, c0, lengths, forget_bias,
                              reverse, residuals)
        return (out[0], *out[1]) + (tuple(out[2]) if residuals else ())
    return _fwd_cuda(x_proj, wh, h0, c0, lengths, forget_bias, reverse,
                     residuals)


class _LSTMScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, wh, h0, c0, lengths, forget_bias, reverse):
        ys, h_last, c_last, acts, cs = _forward(
            x_proj, wh, h0, c0, lengths, forget_bias, reverse, True)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(wh, h0, c0, lengths, ys, acts, cs)
        return ys, h_last, c_last

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        wh, h0, c0, lengths, ys, acts, cs = ctx.saved_tensors
        dt = acts.dtype
        H = acts.shape[2] // 4
        # BiRNN discards the last states: their cotangents arrive as None
        dys = torch.zeros_like(ys) if dys is None else dys
        dh_last = h0.new_zeros(h0.shape, dtype=dt) if dh_last is None \
            else dh_last
        dc_last = torch.zeros_like(cs[:, 0]) if dc_last is None else dc_last
        bwd = lstm_scan_bwd_plain if acts.device.type == "cpu" \
            else _bwd_cuda
        dgates, dh0, dc0 = bwd(wh, c0, lengths, acts, cs, dys, dh_last,
                               dc_last, ctx.reverse)
        dwh = None
        if ctx.needs_input_grad[1]:
            h_prev = rnn_scan.prev_states(ys, h0, lengths, ctx.reverse)
            dwh = (h_prev.reshape(-1, H).float().t() @
                   dgates.reshape(-1, 4 * H).float()).to(dt).to(wh.dtype)
        return (dgates, dwh, dh0.to(h0.dtype), dc0.to(c0.dtype), None, None,
                None)


def lstm_scan(x_proj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, lengths: torch.Tensor,
              forget_bias: float = 1.0, reverse: bool = False,
              residuals: bool = False) -> Tuple:
    """(ys, (h_last, c_last)), differentiable; or, with ``residuals`` and
    outside autograd, (ys, (h_last, c_last), (acts, cs))."""
    if not residuals and rnn_scan.needs_grad(x_proj, wh, h0, c0):
        ys, h_last, c_last = _LSTMScan.apply(x_proj, wh, h0, c0, lengths,
                                             float(forget_bias), reverse)
        return ys, (h_last, c_last)
    with torch.no_grad():
        out = _forward(x_proj, wh, h0, c0, lengths, forget_bias, reverse,
                       residuals)
    if residuals:
        return out[0], (out[1], out[2]), (out[3], out[4])
    return out[0], (out[1], out[2])
