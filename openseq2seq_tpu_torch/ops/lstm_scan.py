"""The LSTM recurrence on the hand-written CUDA kernel
``csrc/lstm_scan_fwd.cu`` (port of ``openseq2seq_tpu/ops/lstm_pallas.py``,
kernel B3's forward).

:func:`lstm_scan` runs the LSTM over pre-projected inputs x_proj
(B, T, 4H), gates blocked [i | f | g | o], with W_h (H, 4H) (no recurrent
bias), h0 (B, H), the fp32 cell state c0 (B, H), int32 lengths (B,) and
the forget bias added inside the forget gate's sigmoid. It returns ys
(B, T, H), zero past each row's length (the layer's output mask, applied
by the kernel), and (h_last, c_last), c_last in fp32; with ``residuals``
also (acts (B, T, 4H) = [i, f, tanh(g), o], cs (B, T, H) = the unmasked
fp32 cell state of each step), what the TPU kernel saves for its
backward, at the original time index. ``reverse`` walks t from T - 1
down to 0 with the mask t < length, as ``ops/gru_scan.py`` does.

The numbers are the TPU kernel's, not the ``lax.scan``'s: x_proj + h W_h
is formed in fp32 from the compute-type h and W_h with fp32 accumulation
(the scan rounds the sum to the compute type first), h is rounded to the
compute type as it is carried and c stays fp32. :func:`lstm_scan_plain`
is that arithmetic in PyTorch, step by step.

For CPU tensors :func:`lstm_scan` is :func:`lstm_scan_plain`, which
autograd differentiates. For CUDA tensors it launches the kernel
(``LAUNCHES`` counts the launches) inside a ``torch.autograd.Function``
whose backward raises: B3's backward comes with the training slice of
the RNN speech models. Anything the kernel does not take raises; there
is no fallback.

:func:`supported` is the JAX package's gate (``lstm_pallas.supported``)
without its backend test, with ``_pick_bblk``'s VMEM budget kept as it
is.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rnn_scan

LAUNCHES = 0
KERNEL = "lstm_scan_fwd"

_BUDGET = 11 * 1024 * 1024


def _pick_bblk(B: int, H: int) -> int:
    wh = H * 4 * H * 2
    for bblk in sorted({d for d in range(1, B + 1) if B % d == 0},
                       reverse=True):
        streams = bblk * 4 * H * 2 * 2 + bblk * H * (2 * 4 + 4)
        if wh + 2 * streams + bblk * H * 8 <= _BUDGET:
            return bblk
    return 0


def supported(B: int, T: int, H: int) -> bool:
    if H % 128 != 0 or B < 8:
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


class _LSTMScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, wh, h0, c0, lengths, forget_bias, reverse,
                residuals):
        return _fwd_cuda(x_proj, wh, h0, c0, lengths, forget_bias, reverse,
                         residuals)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the LSTM scan kernel has no backward yet: B3's backward comes "
            "with the training slice of the RNN speech models (ROADMAP.md)")


def lstm_scan(x_proj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, lengths: torch.Tensor,
              forget_bias: float = 1.0, reverse: bool = False,
              residuals: bool = False) -> Tuple:
    """(ys, (h_last, c_last)), or (ys, (h_last, c_last), (acts, cs)) with
    ``residuals``."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, wh, h0, c0, lengths, forget_bias,
                               reverse, residuals)
    out = _LSTMScan.apply(x_proj, wh, h0, c0, lengths, forget_bias, reverse,
                          residuals)
    if residuals:
        return out[0], (out[1], out[2]), (out[3], out[4])
    return out[0], (out[1], out[2])
