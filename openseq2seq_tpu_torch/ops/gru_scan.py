"""The GRU recurrence on the hand-written CUDA kernel
``csrc/gru_scan_fwd.cu`` (port of ``openseq2seq_tpu/ops/gru_pallas.py``,
kernel B4's forward).

:func:`gru_scan` runs the cuDNN-variant GRU over pre-projected inputs
x_proj (B, T, 3H), gates blocked [r | z | n], with W_h (H, 3H), the fp32
recurrent bias b_h (3H,), h0 (B, H) and int32 lengths (B,). It returns
ys (B, T, H), zero past each row's length (the layer's output mask,
applied by the kernel), and h_last (B, H); with ``residuals`` also
(acts (B, T, 3H) = [r, z, n], hn (B, T, H) = the H-side candidate term),
what the TPU kernel saves for its backward, at the original time index.
``reverse`` walks t from T - 1 down to 0 with the mask t < length: the
JAX package's flip, suffix mask and flip back, without flipped copies.

The numbers are the TPU kernel's, not the ``lax.scan``'s: the products
h W_h accumulate in fp32 from the compute-type h and W_h (no rounding
before the bias), the gates run in fp32, and h is rounded to the compute
type as it is carried. :func:`gru_scan_plain` is that arithmetic in
PyTorch, step by step.

For CPU tensors :func:`gru_scan` is :func:`gru_scan_plain`, which autograd
differentiates. For CUDA tensors it launches the kernel (``LAUNCHES``
counts the launches) inside a ``torch.autograd.Function`` whose backward
raises: B4's backward comes with the DeepSpeech2 training slice. Anything
the kernel does not take raises; there is no fallback.

:func:`supported` is the JAX package's gate (``gru_pallas.supported``)
without its backend test, with ``_pick_bblk``'s VMEM budget kept as it
is, so that a layer takes the fused path exactly where the JAX package's
does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rnn_scan

LAUNCHES = 0
KERNEL = "gru_scan_fwd"

_BUDGET = 11 * 1024 * 1024


def _pick_bblk(B: int, H: int) -> int:
    wh = H * 3 * H * 2
    for bblk in sorted({d for d in range(1, B + 1) if B % d == 0},
                       reverse=True):
        streams = bblk * 3 * H * 2 * 2 + bblk * H * 2 * 4
        if wh + 2 * streams + bblk * H * 8 <= _BUDGET:
            return bblk
    return 0


def supported(B: int, T: int, H: int) -> bool:
    if H % 128 != 0 or B < 8:
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


class _GRUScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, wh, bh, h0, lengths, reverse, residuals):
        return _fwd_cuda(x_proj, wh, bh, h0, lengths, reverse, residuals)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the GRU scan kernel has no backward yet: B4's backward comes "
            "with the DeepSpeech2 training slice (ROADMAP.md)")


def gru_scan(x_proj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
             h0: torch.Tensor, lengths: torch.Tensor, reverse: bool = False,
             residuals: bool = False) -> Tuple:
    """(ys, h_last), or (ys, h_last, (acts, hn)) with ``residuals``."""
    if x_proj.device.type == "cpu":
        return gru_scan_plain(x_proj, wh, bh, h0, lengths, reverse,
                              residuals)
    out = _GRUScan.apply(x_proj, wh, bh, h0, lengths, reverse, residuals)
    return (out[0], out[1], tuple(out[2:])) if residuals else tuple(out)
