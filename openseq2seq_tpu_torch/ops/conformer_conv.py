"""The Conformer's convolution module on the hand-written CUDA kernels
``csrc/conformer_conv_fwd.cu`` and ``csrc/conformer_conv_bwd.cu`` (kernel
B6, forward and backward).

Port of ``openseq2seq_tpu/ops/conformer_pallas.py`` (``_fused`` with
``_compute_forward``, ``:122-155`` and ``:325-352``; its VJP ``_fused_bwd``
with ``_bwd_kernel``, ``:158-247`` and ``:363-420``; entry
``conformer_conv_module``, ``:426-441``): the layer-norm variant of
``encoders/conformer_encoder._ConvModule`` as one function,

    y = pw2(swish(LN2(dwconv_k(mask(GLU(pw1(LN1(x))))))))

with that kernel's precision: an fp32 chain, the layer norms' fast
variance E[x^2] - E[x]^2 (eps 1e-6; not ``F.layer_norm``'s two-pass one),
the two pointwise products on operands rounded to x's type with fp32
accumulation (bf16 for bf16 x, fp32 otherwise), the depthwise taps in
fp32, and y in x's type. Dropout and the residual add are the caller's.

When a gradient is needed :func:`conformer_conv_module` is a
``torch.autograd.Function`` on both devices that keeps only x, the
lengths and the weights, as the JAX package's VJP does: the backward
recomputes the forward in fp32 and returns dx in x's type and the ten
weight gradients in fp32, summed over the batch, every product again on
operands rounded to x's type. Padded frames keep their gradients, as in
the TPU kernel: only the depthwise input's gradient is masked.

:func:`supported` keeps what belongs to the function: the layer-norm
variant only (batch norm's running statistics are training state). The
TPU kernel's VMEM budget has no counterpart; the CUDA kernels' own limits
are ``kernel_supports``: D a multiple of 64 from 64 to 512 (Conformer-M's
256 and -L's 512) and 1 <= k <= 63 (the recipes' 31).

For CPU tensors the ops run their plain versions
(:func:`conformer_conv_module_plain`, :func:`conformer_conv_module_bwd_plain`);
for CUDA tensors they launch the kernels (the products on the tensor cores
for bf16, on the CUDA cores for fp32) or raise, outside those limits too,
and where a bf16 launch's CTA would not fit an SM (:func:`check_fits`,
from the kernels' own resource entries, before any launch). There is no
other fallback. ``LAUNCHES`` counts calls that launch the forward kernels
(bf16: the weights' rounding pre-pass and one fused launch; fp32: two
launches; a call counts once) and ``BWD_LAUNCHES`` calls that launch the
backward's (six for bf16, fifteen for fp32).

The bf16 checks (below) hold every stage from the kernels' own state and
must refuse planted faults: ``bounds.zero_but_row_1``, and those a tiled
design could commit (:func:`fwd_faults`, :func:`bwd_faults`).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .bounds import (BF16_ULP, CELL, F32_U, flips, reading, sigmoid,
                     zero_but_row_1)

LAUNCHES = 0
BWD_LAUNCHES = 0
# the backward's results: dx, then the ten weight gradients
GRADS = ("dx", "dln1s", "dln1b", "dw1", "db1", "dwd", "dbd", "dln2s",
         "dln2b", "dw2", "db2")
KERNEL = "conformer_conv_fwd"
BWD_KERNEL = "conformer_conv_bwd"
EPS = 1e-6
MAX_DIM = 512
MAX_KERNEL_SIZE = 63
_fns = {}
_fits = {}        # (entry, D, k, tile, device) -> the bf16 resources
_workspaces = {}  # (B, T, D, k, bf16, tile, device) -> bytes


def _kernel(entry: str = KERNEL):
    fn = _fns.get(entry)
    if fn is None:
        from ..kernels import build
        lib = build.load(BWD_KERNEL if entry.startswith(BWD_KERNEL)
                         else KERNEL)
        fn = getattr(lib, entry)
        if entry == KERNEL:
            # x, lens, 10 weights, wb, u, y; B, T, D, k, is_bf16, tile
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        elif entry == BWD_KERNEL:
            # x, dy, lens, 10 weights, workspace, dx, 10 gradients, inter
            fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 6 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        elif entry.endswith("_workspace"):
            fn.argtypes = [ctypes.c_int] * 6
            fn.restype = ctypes.c_longlong
        else:                                   # the *_resources entries
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def fwd_resources(D: int, k: int, tile: int = 0) -> tuple:
    """(frames a CTA, dynamic shared memory in bytes, CTAs an SM) of the
    bf16 forward's fused kernel at width D and k taps, from its C entry
    ``conformer_conv_fwd_resources`` (nothing launched): ``tile`` 0 takes
    the largest of 64, 32, 16 frames that fits an SM, else that tile; 0
    frames or 0 CTAs where it does not fit. Needs a CUDA device."""
    out = (ctypes.c_int * 3)()
    err = _kernel(KERNEL + "_resources")(D, k, tile, out)
    if err != 0:
        raise RuntimeError("{}_resources failed: CUDA error {}".format(
            KERNEL, err))
    return tuple(out)


def bwd_resources(D: int, k: int, tile: int = 0) -> tuple:
    """Four (tile, dynamic shared memory, CTAs an SM) of the bf16
    backward's launches 1 to 4 (``csrc/conformer_conv_bwd.cu``): the
    frames a CTA of launches 1 and 2 (chosen as ``fwd_resources`` does),
    the rows of launch 3, the 128 columns of launch 4; from its C entry
    ``conformer_conv_bwd_resources``, nothing launched."""
    out = (ctypes.c_int * 12)()
    err = _kernel(BWD_KERNEL + "_resources")(D, k, tile, out)
    if err != 0:
        raise RuntimeError("{}_resources failed: CUDA error {}".format(
            BWD_KERNEL, err))
    return tuple(tuple(out[i:i + 3]) for i in range(0, 12, 3))


def bwd_workspace(B: int, T: int, D: int, k: int, bf16: bool = True,
                  tile: int = 0) -> int:
    """The backward's workspace in bytes, from its C entry
    ``conformer_conv_bwd_workspace`` (the bf16 chain's: h0, sw and da in
    bf16, dc in fp32, the rounded weights and the partials; the fp32
    chain's: its fp32 intermediates and partials)."""
    return _kernel(BWD_KERNEL + "_workspace")(B, T, D, k, int(bf16), tile)


def check_fits(entry: str, D: int, k: int, tile: int,
               device: torch.device) -> None:
    """Raise ValueError, naming the shape, where a CTA of a bf16 launch of
    ``entry`` (``KERNEL`` or ``BWD_KERNEL``) at (D, k, tile) does not fit
    an SM of ``device``, as the kernels' own resource entries report it
    (``fwd_resources``, ``bwd_resources``; remembered); nothing is
    launched."""
    key = (entry, D, k, tile, device.index)
    if key not in _fits:
        with torch.cuda.device(device):
            _fits[key] = (fwd_resources(D, k, tile),) if entry == KERNEL \
                else bwd_resources(D, k, tile)
    for i, (tm, smem, ctas) in enumerate(_fits[key]):
        if tm == 0 or ctas == 0:
            raise ValueError(
                "the conv module's bf16 {} takes no CTA at D = {}, k = {}, "
                "tile {}: it needs {} bytes of shared memory, more than an "
                "SM of {} gives one".format(
                    "forward" if entry == KERNEL else
                    "backward launch {}".format(i + 1), D, k,
                    tile or "any", smem, torch.cuda.get_device_name(device)))


def supported(conv_norm: str) -> bool:
    """Whether the fused module computes this variant: layer norm only."""
    return conv_norm == "layer_norm"


def kernel_supports(D: int, k: int) -> bool:
    """The CUDA kernel's limits on the width D and the depthwise taps k."""
    return D % 64 == 0 and 64 <= D <= MAX_DIM and 1 <= k <= MAX_KERNEL_SIZE


def _ln_fwd(x32, eps):
    """``_ln_fwd`` (``conformer_pallas.py:64``) without the affine part:
    (xh, rstd), the fast variance E[x^2] - E[x]^2."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd, rstd


def _layer_norm(x32, scale, bias, eps):
    return _ln_fwd(x32, eps)[0] * scale.float() + bias.float()


def _mxu(x):
    """The products' operand type: bf16 for bf16 x, fp32 otherwise."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _live(x, lengths):
    T = x.shape[1]
    return (torch.arange(T, device=x.device)[None, :] <
            lengths.to(x.device)[:, None])[..., None]


def conformer_conv_module_plain(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                                pw1_bias, dw_kernel, dw_bias, ln2_scale,
                                ln2_bias, pw2_kernel, pw2_bias,
                                eps: float = EPS,
                                intermediates: bool = False):
    """The kernel's function in torch ops at its precision. x (B, T, D);
    lengths (B,); pw1_kernel (D, 2D), dw_kernel (k, D), pw2_kernel (D, D)
    and the norms' and biases' vectors, fp32. Returns (B, T, D) in x's
    dtype; with ``intermediates`` (y, {"u": u}), u = mask(GLU(pw1(LN1(x))))
    as the kernel's first launch writes it."""
    B, T, D = x.shape
    k = dw_kernel.shape[0]
    mxu = _mxu(x)

    def product(a, w):
        # operands rounded to the product type, exact fp32 products
        return a.to(mxu).float() @ w.to(mxu).float()

    h0 = _layer_norm(x.float(), ln1_scale, ln1_bias, eps)
    a = product(h0, pw1_kernel) + pw1_bias.float()
    u = a[..., :D] * torch.sigmoid(a[..., D:])
    u = torch.where(_live(x, lengths), u, 0.0)
    # the taps over the row only: zeros outside [0, T), XLA's SAME offsets
    halo = (k - 1) // 2
    up = F.pad(u, (0, 0, halo, k - 1 - halo))
    c = torch.zeros_like(u)
    for j in range(k):
        c = c + dw_kernel[j].float() * up[:, j:j + T]
    n = _layer_norm(c + dw_bias.float(), ln2_scale, ln2_bias, eps)
    y = product(n * torch.sigmoid(n), pw2_kernel) + pw2_bias.float()
    return (y.to(x.dtype), {"u": u}) if intermediates else y.to(x.dtype)


def _ln_bwd(dh, xh, rstd, scale):
    """``_ln_bwd`` (``conformer_pallas.py:75``): (dx, dscale, dbias),
    the two parameter gradients summed over every row."""
    dxh = dh * scale
    dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True) -
                 xh * (dxh * xh).mean(dim=-1, keepdim=True))
    return dx, (dh * xh).sum(dim=(0, 1)), dh.sum(dim=(0, 1))


def conformer_conv_module_bwd_plain(x, lengths, ln1_scale, ln1_bias,
                                    pw1_kernel, pw1_bias, dw_kernel, dw_bias,
                                    ln2_scale, ln2_bias, pw2_kernel, pw2_bias,
                                    dy, eps: float = EPS,
                                    intermediates: bool = False):
    """The backward kernels' plain version at ``_bwd_kernel``'s precision
    (``conformer_pallas.py:158-247``): the forward recomputed in fp32,
    every product on operands rounded to x's type (pw1 again, then dw2 =
    sw^T dy, ds = dy w2^T, dw1 = h0^T da, dh0 = da w1^T), the depthwise
    conv's transpose within each row, the time mask on its input's
    gradient only. Returns dx in x's dtype and the ten weight gradients in
    fp32, in the order of the weights (``GRADS``); with ``intermediates``
    also a dict of the values the kernels keep in their workspace
    (``bwd_intermediates``)."""
    B, T, D = x.shape
    k = dw_kernel.shape[0]
    P = (k - 1) // 2
    mxu = _mxu(x)
    w = [t.float() for t in (ln1_scale, ln1_bias, pw1_kernel, pw1_bias,
                             dw_kernel, dw_bias, ln2_scale, ln2_bias,
                             pw2_kernel, pw2_bias)]
    ln1s, ln1b, w1, b1, wd, bd, ln2s, ln2b, w2, b2 = w

    def rnd(a):
        return a.to(mxu).float()

    def rows(a):
        return a.reshape(-1, a.shape[-1])

    live = _live(x, lengths)
    xh1, rstd1 = _ln_fwd(x.float(), eps)
    h0 = xh1 * ln1s + ln1b
    a = rnd(h0) @ rnd(w1) + b1
    p, q = a[..., :D], a[..., D:]
    sq = torch.sigmoid(q)
    u = torch.where(live, p * sq, 0.0)
    up = F.pad(u, (0, 0, P, k - 1 - P))
    c = bd.expand_as(u)
    for j in range(k):
        c = c + wd[j] * up[:, j:j + T]
    xh2, rstd2 = _ln_fwd(c, eps)
    n = xh2 * ln2s + ln2b
    sn = torch.sigmoid(n)
    sw = n * sn

    dy32 = dy.float()
    dw2 = rows(rnd(sw)).t() @ rows(rnd(dy32))
    db2 = dy32.sum(dim=(0, 1))
    ds = rnd(dy32) @ rnd(w2).t()
    dn = ds * (sn + n * sn * (1.0 - sn))
    dc, dln2s, dln2b = _ln_bwd(dn, xh2, rstd2, ln2s)
    dbd = dc.sum(dim=(0, 1))
    # c[t] = sum_j wd[j] u[t + j - P]: du[t] = sum_j wd[j] dc[t - j + P],
    # dwd[j] = sum_t u[t + j - P] dc[t], all within the row
    dcp = F.pad(dc, (0, 0, k - 1 - P, P))
    du = torch.zeros_like(dc)
    dwd = torch.empty_like(wd)
    for j in range(k):
        du = du + wd[j] * dcp[:, k - 1 - j:k - 1 - j + T]
        dwd[j] = (up[:, j:j + T] * dc).sum(dim=(0, 1))
    du = torch.where(live, du, 0.0)
    da = torch.cat([du * sq, du * p * sq * (1.0 - sq)], dim=-1)
    dw1 = rows(rnd(h0)).t() @ rows(rnd(da))
    db1 = da.sum(dim=(0, 1))
    dh0 = rnd(da) @ rnd(w1).t()
    dx, dln1s, dln1b = _ln_bwd(dh0, xh1, rstd1, ln1s)
    grads = (dx.to(x.dtype), dln1s, dln1b, dw1, db1, dwd, dbd, dln2s, dln2b,
             dw2, db2)
    if intermediates:
        return grads, {"h0": h0, "a": a, "c": c, "ds": ds, "sw": sw,
                       "dc": dc, "da": da, "dh0": dh0}
    return grads


# The bf16 bounds. Like the scans' (``ops/scan_bounds.py``) they hold each
# stage on its own, from the state the implementation under test reached
# before it: the forward kernel's u (the output of its first launch) and
# the backward kernels' fp32 intermediates (their workspace, see
# ``bwd_intermediates``), each stage recomputed in fp64 from its inputs.
# An element's bound is built from its own terms: 2 n 2^-24 of the terms'
# sizes for a sum of n terms in another order, ``bounds.CELL`` of the
# magnitude of elementwise math, slopes times their inputs' errors, and for a product on
# operands rounded to bf16 ``_sum_bound``'s terms. A stage whose operand
# is the implementation's own fp32 value rounds it as the implementation
# does; one whose operand is recomputed (h0 before pw1, in the forward)
# may round it the other way only where the value's error straddles a
# rounding point (``bounds.flips``); y's last product takes one ulp of each
# rounded swish(n), as ``_sum_bound`` does. An output rounded to bf16 adds
# one ulp of itself.


def _rnd(v):
    return v.to(torch.bfloat16).double()


def _ln_err(v, e_v, eps):
    """``_ln_fwd`` of rows v within e_v: (xh, rstd, e_xh, e_rstd)."""
    D = v.shape[-1]
    mu = v.mean(-1, keepdim=True)
    m2 = (v * v).mean(-1, keepdim=True)
    rstd = torch.rsqrt(m2 - mu * mu + eps)
    e_mu = e_v.mean(-1, keepdim=True) + \
        2 * (D + 1) * F32_U * v.abs().mean(-1, keepdim=True)
    e_m2 = ((2 * v.abs() + e_v) * e_v).mean(-1, keepdim=True) + \
        2 * (D + 2) * F32_U * m2
    e_var = e_m2 + (2 * mu.abs() + e_mu) * e_mu + 4 * F32_U * (m2 + mu * mu)
    # rsqrt's slope and its change over e_var; 2 ulps of rsqrtf
    e_rstd = 0.5 * rstd ** 3 * e_var * (1 + 2 * e_var * rstd ** 2) + \
        8 * F32_U * rstd
    xc = v - mu
    xh = xc * rstd
    e_xh = (e_v + e_mu) * (rstd + e_rstd) + xc.abs() * e_rstd + \
        4 * F32_U * xh.abs()
    return xh, rstd, e_xh, e_rstd


def _ln_bwd_err(dh, e_dh, xh, e_xh, rstd, e_rstd, scale):
    """``_ln_bwd`` with errors: (dx, e_dx, dscale, e_dscale, dbias,
    e_dbias), the parameter gradients summed over every row."""
    D = dh.shape[-1]
    rows = dh.numel() // D
    dxh = dh * scale
    e_dxh = scale.abs() * e_dh + 2 * F32_U * dxh.abs()
    a = dxh.mean(-1, keepdim=True)
    e_a = e_dxh.mean(-1, keepdim=True) + \
        2 * (D + 1) * F32_U * dxh.abs().mean(-1, keepdim=True)
    b = (dxh * xh).mean(-1, keepdim=True)
    e_b = (e_dxh * (xh.abs() + e_xh) + dxh.abs() * e_xh).mean(
        -1, keepdim=True) + 2 * (D + 2) * F32_U * (dxh * xh).abs().mean(
            -1, keepdim=True)
    inner = dxh - a - xh * b
    e_in = e_dxh + e_a + e_xh * (b.abs() + e_b) + xh.abs() * e_b + \
        CELL * (dxh.abs() + a.abs() + (xh * b).abs())
    dx = rstd * inner
    e_dx = inner.abs() * e_rstd + (rstd + e_rstd) * e_in + \
        2 * F32_U * dx.abs()
    e_dh_xh = e_dh * (xh.abs() + e_xh) + dh.abs() * e_xh
    return (dx, e_dx, (dh * xh).sum(dim=(0, 1)),
            e_dh_xh.sum(dim=(0, 1)) +
            2 * rows * F32_U * (dh * xh).abs().sum(dim=(0, 1)),
            dh.sum(dim=(0, 1)),
            e_dh.sum(dim=(0, 1)) + 2 * rows * F32_U * dh.abs().sum(dim=(0, 1)))


def _taps(v, wd, P, reverse=False):
    """sum_j wd[j] v[t + j - P] within each row (the depthwise conv), or
    with ``reverse`` its transpose sum_j wd[j] v[t - j + P]."""
    k, T = wd.shape[0], v.shape[1]
    vp = F.pad(v, (0, 0, k - 1 - P, P) if reverse else (0, 0, P, k - 1 - P))
    out = torch.zeros_like(v)
    for j in range(k):
        s = k - 1 - j if reverse else j
        out = out + wd[j] * vp[:, s:s + T]
    return out


def _sum(out, terms, n):
    """The bound of a sum of n terms taken in another order, ``terms``
    their sizes summed, plus the fp32 add into out."""
    return 2 * n * F32_U * terms + 2 * F32_U * out.abs()


def _glu(a, e_a, live):
    """u = mask(GLU(a)) from a (fp64) within e_a: u, its error, p,
    sigmoid(q) and that's error."""
    D = a.shape[-1] // 2
    p, e_p = a[..., :D], e_a[..., :D]
    sq, e_sq = sigmoid(a[..., D:], e_a[..., D:])
    u = torch.where(live, p * sq, 0.0)
    return u, torch.where(live, sq * e_p + (p.abs() + e_p) * e_sq +
                          CELL * u.abs(), 0.0), p, sq, e_sq


def _swish(c, e_c, eps, ln2s, ln2b):
    """LN2 and the swish from c (fp64) within e_c: the LN statistics, n,
    sigmoid(n), sw and their errors."""
    xh, rstd, e_xh, e_rstd = _ln_err(c, e_c, eps)
    n = xh * ln2s + ln2b
    e_n = ln2s.abs() * e_xh + 4 * F32_U * ((xh * ln2s).abs() + ln2b.abs())
    sn = torch.sigmoid(n)
    # the swish's slope is at most 1.1, its change at most 0.5 a unit
    e_sw = ((sn + n * sn * (1 - sn)).abs() + 0.5 * e_n) * e_n + \
        CELL * (n * sn).abs()
    return xh, rstd, e_xh, e_rstd, n, e_n, sn, n * sn, e_sw


def _conv_c(u, e_u, wd, bd):
    k = wd.shape[0]
    P = (k - 1) // 2
    c = bd + _taps(u, wd, P)
    return c, _taps(e_u, wd.abs(), P) + 2 * (k + 1) * F32_U * (
        bd.abs() + _taps(u.abs(), wd.abs(), P))


def conformer_conv_module_bounds(x, lengths, u, ln1_scale, ln1_bias,
                                 pw1_kernel, pw1_bias, dw_kernel, dw_bias,
                                 ln2_scale, ln2_bias, pw2_kernel, pw2_bias,
                                 eps: float = EPS) -> dict:
    """Bounds of a bf16 forward's u (its first launch's fp32 output, held
    from x) and y (held from that u): ``{"u": (want, bound), "y": (want,
    bound)}``, fp64 in their shapes."""
    ln1s, ln1b, w1, b1, wd, bd, ln2s, ln2b, w2, b2 = (w.double() for w in (
        ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
        ln2_scale, ln2_bias, pw2_kernel, pw2_bias))
    D = x.shape[2]
    live = _live(x, lengths)
    xh1, _, e_xh1, _ = _ln_err(x.double(), torch.zeros_like(
        x, dtype=torch.float64), eps)
    h0 = xh1 * ln1s + ln1b
    e_h0 = ln1s.abs() * e_xh1 + 4 * F32_U * ((xh1 * ln1s).abs() + ln1b.abs())
    w1r, w2r = _rnd(w1), _rnd(w2)
    a = _rnd(h0) @ w1r + b1
    e_a = flips(h0, e_h0).abs() @ w1r.abs() + _sum(
        a, _rnd(h0).abs() @ w1r.abs() + b1.abs(), D + 1)
    want_u, e_u = _glu(a, e_a, live)[:2]
    c, e_c = _conv_c(u.double(), torch.zeros_like(e_u), wd, bd)
    *_, sw, e_sw = _swish(c, e_c, eps, ln2s, ln2b)
    y = _rnd(sw) @ w2r + b2
    # flash_attention._sum_bound's terms, in fp64, and the bias's add
    ulp = BF16_ULP
    terms = ((ulp + D * 2.0 ** -23) * _rnd(sw).abs() + e_sw) @ w2r.abs()
    return {"u": (want_u, e_u),
            "y": (y, ulp * y.abs() + (1 + ulp) * (terms +
                                                  _sum(y, b2.abs(), 1)))}


# the backward's fp32 intermediates in order, with their widths in D: the
# fp32 chain's workspace begins with the first eight; the bf16 chain writes
# all nine to the buffer ``intermediates=True`` passes it, "a again" being
# its second launch's recompute of a (the same bits as the first's)
INTERMEDIATES = (("h0", 1), ("a", 2), ("c", 1), ("ds", 1), ("sw", 1),
                 ("dc", 1), ("da", 2), ("dh0", 1), ("a again", 2))


def bwd_intermediates(buf, B, T, D, count: int = len(INTERMEDIATES)) -> dict:
    """Views of the backward kernels' fp32 intermediates in ``buf`` (the
    first ``count`` of ``INTERMEDIATES``, each (B, T, width D))."""
    nd = B * T * D
    f = buf.view(torch.float32)
    out, at = {}, 0
    for name, width in INTERMEDIATES[:count]:
        out[name] = f[at:at + width * nd].view(B, T, width * D)
        at += width * nd
    return out


def conformer_conv_module_bwd_bounds(x, lengths, inter, ln1_scale, ln1_bias,
                                     pw1_kernel, pw1_bias, dw_kernel,
                                     dw_bias, ln2_scale, ln2_bias,
                                     pw2_kernel, pw2_bias, dy,
                                     eps: float = EPS,
                                     depth: dict | None = None) -> dict:
    """Bounds of a bf16 backward's intermediates ``inter`` (h0, a, c, ds,
    sw, dc, da, dh0: its fp32 values, each held from the ones before it)
    and of its outputs (dx, held from its dh0, and the ten weight
    gradients from its intermediates): ``{name: (want, bound)}``, fp64,
    the gradients named as in ``GRADS``. ``depth`` (``sum_depth``) gives
    the most additions a term of db1, dwd, dw1 or dw2 passes through in
    the kernels' fixed order of summation; without it those sums are held
    for any order (B T terms)."""
    ln1s, ln1b, w1, b1, wd, bd, ln2s, ln2b, w2, b2 = (w.double() for w in (
        ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
        ln2_scale, ln2_bias, pw2_kernel, pw2_bias))
    B, T, D = x.shape
    k, N = wd.shape[0], B * T
    P = (k - 1) // 2
    live = _live(x, lengths)
    h0_k, a_k, c_k, ds_k, sw_k, dc_k, da_k, dh0_k = (
        inter[n].double() for n in ("h0", "a", "c", "ds", "sw", "dc", "da",
                                    "dh0"))
    w1r, w2r, dy = _rnd(w1), _rnd(w2), dy.double()
    out = {}
    xh1, rstd1, e_xh1, e_rstd1 = _ln_err(x.double(), torch.zeros_like(
        x, dtype=torch.float64), eps)
    h0 = xh1 * ln1s + ln1b
    out["h0"] = (h0, ln1s.abs() * e_xh1 + 4 * F32_U * (
        (xh1 * ln1s).abs() + ln1b.abs()))
    a = _rnd(h0_k) @ w1r + b1
    out["a"] = (a, _sum(a, _rnd(h0_k).abs() @ w1r.abs() + b1.abs(), D + 1))
    u, e_u, p, sq, e_sq = _glu(a_k, torch.zeros_like(a_k), live)
    out["c"] = _conv_c(u, e_u, wd, bd)
    ds = dy @ w2r.t()
    out["ds"] = (ds, _sum(ds, dy.abs() @ w2r.abs().t(), D + 1))
    xh2, rstd2, e_xh2, e_rstd2, n, e_n, sn, sw, e_sw = _swish(
        c_k, torch.zeros_like(c_k), eps, ln2s, ln2b)
    out["sw"] = (sw, e_sw)
    g = sn + n * sn * (1 - sn)
    dn = ds_k * g
    e_dn = ds_k.abs() * (0.5 * e_n + CELL * (sn + n.abs() * sn * (1 + sn)))
    dc, e_dc, dln2s, e_dln2s, dln2b, e_dln2b = _ln_bwd_err(
        dn, e_dn + CELL * dn.abs(), xh2, e_xh2, rstd2, e_rstd2, ln2s)
    out["dc"] = (dc, e_dc)
    du = torch.where(live, _taps(dc_k, wd, P, reverse=True), 0.0)
    e_du = torch.where(live, 2 * (k + 1) * F32_U * _taps(
        dc_k.abs(), wd.abs(), P, reverse=True), 0.0)
    f2 = p * sq * (1 - sq)
    e_f2 = p.abs() * e_sq + CELL * p.abs() * sq * (1 + sq)
    da = torch.cat([du * sq, du * f2], dim=-1)
    out["da"] = (da, torch.cat([sq * e_du + du.abs() * e_sq,
                                f2.abs() * e_du + du.abs() * e_f2], dim=-1) +
                 CELL * da.abs())
    dh0 = _rnd(da_k) @ w1r.t()
    out["dh0"] = (dh0, _sum(dh0, _rnd(da_k).abs() @ w1r.abs().t(), 2 * D))
    dx, e_dx, dln1s, e_dln1s, dln1b, e_dln1b = _ln_bwd_err(
        dh0_k, torch.zeros_like(dh0_k), xh1, e_xh1, rstd1, e_rstd1, ln1s)
    out["dx"] = (dx, BF16_ULP * dx.abs() + (1 + BF16_ULP) * e_dx)
    out["dln1s"], out["dln1b"] = (dln1s, e_dln1s), (dln1b, e_dln1b)

    def rows_product(lhs, rhs):
        prod = torch.einsum("btd,bte->de", lhs, rhs)
        return prod, _sum(prod, torch.einsum("btd,bte->de", lhs.abs(),
                                             rhs.abs()), depth["dw"])
    depth = depth or {"db1": N, "dwd": N, "dw": N}
    out["dw1"] = rows_product(_rnd(h0_k), _rnd(da_k))
    out["db1"] = (da_k.sum(dim=(0, 1)),
                  _sum(da_k.sum(dim=(0, 1)), da_k.abs().sum(dim=(0, 1)),
                       depth["db1"]))
    up, e_up = (F.pad(v, (0, 0, P, k - 1 - P)) for v in (u, e_u))
    dwd = torch.stack([(up[:, j:j + T] * dc_k).sum(dim=(0, 1))
                       for j in range(k)])
    out["dwd"] = (dwd, torch.stack([
        (e_up[:, j:j + T] * dc_k.abs()).sum(dim=(0, 1)) for j in range(k)]) +
        _sum(dwd, torch.stack([(up[:, j:j + T] * dc_k).abs().sum(dim=(0, 1))
                               for j in range(k)]), depth["dwd"]))
    out["dbd"] = (dc_k.sum(dim=(0, 1)),
                  _sum(dc_k.sum(dim=(0, 1)), dc_k.abs().sum(dim=(0, 1)), N))
    out["dln2s"], out["dln2b"] = (dln2s, e_dln2s), (dln2b, e_dln2b)
    out["dw2"] = rows_product(_rnd(sw_k), dy)
    out["db2"] = (dy.sum(dim=(0, 1)),
                  _sum(dy.sum(dim=(0, 1)), dy.abs().sum(dim=(0, 1)), N))
    return out


# The planted faults a check must refuse, each a wrong kernel's output read
# against the right one's bounds: besides ``bounds.zero_but_row_1``, the
# faults a tiled design could commit. ``tile`` is the frames a CTA owns
# (the forward kernel's, or the backward's second launch's: the
# ``*_resources`` entries report them).

def fault_tile(T: int, tile: int) -> tuple:
    """(t0, n): the frames of batch row 0 whose halo :func:`fwd_faults`
    drops: the kernel's second tile where the row holds three, else its
    middle third (a shorter row's tile edges lie at 0 and T)."""
    if 3 * tile <= T:
        return tile, tile
    return T // 3, max(1, T // 3)


def dw_splits(N: int) -> tuple:
    """(splits, rows a split) of the B T rows over which the backward sums
    dw1 and dw2: about 1024 rows a split, at most 32 splits, the rows a
    multiple of 64 (``csrc/conformer_conv_bwd.cu``, ``Plan``)."""
    splits = min(32, max(1, -(-N // 1024)))
    rows = -(-(-(-N // splits)) // 64) * 64
    return -(-N // rows), rows


def _tail(parts: int) -> int:
    """The additions of ``reduce_all_kernel`` over ``parts`` partials,
    summed in blocks of ceil(sqrt(parts)): within a block, then the
    blocks."""
    blk = math.isqrt(parts - 1) + 1
    return blk + -(-parts // blk)


def sum_depth(B: int, T: int, tile: int) -> dict:
    """The most additions a term of db1, dwd, dw1 or dw2 passes through in
    the backward kernels' order, for their second launch's ``tile``
    frames a CTA: for db1 and dwd a thread's rows (tile / 8 for db1, the
    tile for dwd), the eight thread groups (db1), then the B ceil(T /
    tile) partials; for dw1 and dw2 (``"dw"``) a split's rows of
    :func:`dw_splits`, which ``weight_grads_kernel`` takes 16 at a time
    by mma.sync m16n8k16 (a term's own k16 step counted as 32 additions,
    each later one as 17, as ``scan_bounds.sum_depth`` counts the
    tensor core's truncating adder), then the splits' partials. Each sum
    of partials is ``reduce_all_kernel``'s, in blocks of ceil(sqrt) of
    them."""
    splits, rows = dw_splits(B * T)
    tail = _tail(B * -(-T // tile))
    return {"db1": tile // 8 + 8 + tail, "dwd": tile + tail,
            "dw": 32 + 17 * (rows // 16 - 1) + _tail(splits)}


def fwd_faults(bounds, u, y, weights, tile, eps: float = EPS) -> dict:
    """Readings against a forward's ``bounds`` (``conformer_conv_module_
    bounds``, from its u) of y zeroed on every batch row but row 1, and of
    y with frames :func:`fault_tile` of row 0 recomputed (fp64) from c
    taken with u zero at their halo frames, as a CTA that dropped its
    neighbours' rows would compute them."""
    wd, bd, ln2s, ln2b, w2, b2 = (w.double() for w in weights[4:])
    t0, n = fault_tile(u.shape[1], tile)
    uz = torch.zeros_like(u[:1], dtype=torch.float64)
    uz[:, t0:t0 + n] = u[:1, t0:t0 + n].double()
    c, _ = _conv_c(uz, torch.zeros_like(uz), wd, bd)
    sw = _swish(c, torch.zeros_like(c), eps, ln2s, ln2b)[7]
    bad = y.clone()
    bad[0, t0:t0 + n] = (_rnd(sw) @ _rnd(w2) + b2)[0, t0:t0 + n].to(y.dtype)
    return {"rows zeroed": reading(zero_but_row_1(y), *bounds["y"]),
            "halo zeroed": reading(bad, *bounds["y"])}


def bwd_faults(bounds, lengths, inter, grads, dw_kernel, tile) -> dict:
    """Readings against a backward's ``bounds`` (``conformer_conv_module_
    bwd_bounds``, from its intermediates ``inter``) of four wrong
    gradients: dx zeroed on every batch row but row 1; dw1 without the
    partial of its first CTA (rows d < 128, the first 64 channels' value
    and gate columns, over the first of ``dw_splits``); dwd without the
    partial of the second launch's first CTA (frames 0 .. tile - 1 of
    batch row 0); db1 summed from da rounded to bf16."""
    h0, a, dc, da = (inter[n].double() for n in ("h0", "a", "dc", "da"))
    B, T, D = h0.shape
    k = dw_kernel.shape[0]
    P = (k - 1) // 2
    out = {"rows zeroed": reading(zero_but_row_1(grads[0]),
                                  *bounds["dx"])}
    rows = dw_splits(B * T)[1]
    d1, c1 = min(128, D), min(64, D)
    cols = list(range(c1)) + list(range(D, D + c1))
    dw1 = grads[3].double().clone()
    dw1[:d1, cols] -= _rnd(h0).reshape(-1, D)[:rows, :d1].t() @ \
        _rnd(da).reshape(-1, 2 * D)[:rows, cols]
    out["dw1 partial left out"] = reading(dw1, *bounds["dw1"])
    u = _glu(a[:1], torch.zeros_like(a[:1]), _live(a[:1], lengths[:1]))[0]
    up = F.pad(u, (0, 0, P, k - 1 - P))
    n = min(tile, T)
    dwd = grads[5].double().clone()
    for j in range(k):
        dwd[j] -= (up[0, j:j + n] * dc[0, :n]).sum(dim=0)
    out["dwd partial left out"] = reading(dwd, *bounds["dwd"])
    out["db1 from bf16 da"] = reading(_rnd(da).sum(dim=(0, 1)),
                                      *bounds["db1"])
    return out


def _check(x, lengths, weights):
    """Raise on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError("no conformer conv kernel for device {}".format(
            x.device))
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3 or \
            not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 or fp32 (B, T, D) "
                         "tensor; got {} {}".format(x.dtype, tuple(x.shape)))
    B, T, D = x.shape
    k = weights[4].shape[0]
    if not kernel_supports(D, k) or min(B, T) < 1:
        raise ValueError("the kernel takes D a multiple of 64 up to {} and "
                         "1 <= k <= {}; got D={}, k={} (B={}, T={})".format(
                             MAX_DIM, MAX_KERNEL_SIZE, D, k, B, T))
    shapes = ((D,), (D,), (D, 2 * D), (2 * D,), (k, D), (D,), (D,), (D,),
              (D, D), (D,))
    for w, shape in zip(weights, shapes):
        if w.dtype != torch.float32 or tuple(w.shape) != shape or \
                w.device != x.device or not w.is_contiguous():
            raise ValueError("weights must be contiguous fp32 tensors of "
                             "shapes {} on {}; got {} {} on {}".format(
                                 shapes, x.device, w.dtype, tuple(w.shape),
                                 w.device))
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) or \
            lengths.device != x.device or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 ({},) tensor on "
                         "{}".format(B, x.device))


def conformer_conv_module_cuda(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                               pw1_bias, dw_kernel, dw_bias, ln2_scale,
                               ln2_bias, pw2_kernel, pw2_bias,
                               eps: float = EPS,
                               intermediates: bool = False, tile: int = 0):
    """Launch ``conformer_conv_fwd``; raises on what it does not take.
    With ``intermediates`` (y, {"u": u}), as the plain version's; ``tile``
    picks the bf16 kernel's frames a CTA (64, 32, 16; 0 the largest that
    fits, ``fwd_resources``)."""
    global LAUNCHES
    weights = (ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
               ln2_scale, ln2_bias, pw2_kernel, pw2_bias)
    _check(x, lengths, weights)
    B, T, D = x.shape
    k = dw_kernel.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        check_fits(KERNEL, D, k, tile, x.device)
    wb = torch.empty(3 * D * D, dtype=torch.bfloat16, device=x.device) \
        if bf16 else None
    u = torch.empty((B, T, D), dtype=torch.float32, device=x.device) \
        if intermediates or not bf16 else None
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), lengths.data_ptr(),
                        *(w.data_ptr() for w in weights),
                        None if wb is None else wb.data_ptr(),
                        None if u is None else u.data_ptr(), y.data_ptr(),
                        B, T, D, k, int(bf16), tile, float(eps), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return (y, {"u": u}) if intermediates else y


def conformer_conv_module_cuda_bwd(x, lengths, ln1_scale, ln1_bias,
                                   pw1_kernel, pw1_bias, dw_kernel, dw_bias,
                                   ln2_scale, ln2_bias, pw2_kernel, pw2_bias,
                                   dy, eps: float = EPS,
                                   intermediates: bool = False,
                                   tile: int = 0):
    """Launch ``conformer_conv_bwd`` (several launches, counted as one
    call): (dx, the ten weight gradients) as
    :func:`conformer_conv_module_bwd_plain` returns them, with
    ``intermediates`` also its fp32 intermediates (``bwd_intermediates``:
    bf16 writes them to a buffer of their own, fp32 keeps them in its
    workspace). ``tile`` as in :func:`conformer_conv_module_cuda`, for its
    first two launches. Raises on what it does not take."""
    global BWD_LAUNCHES
    weights = (ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
               ln2_scale, ln2_bias, pw2_kernel, pw2_bias)
    _check(x, lengths, weights)
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous {} {} tensor on {}".format(
            x.dtype, tuple(x.shape), x.device))
    B, T, D = x.shape
    k = dw_kernel.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        check_fits(BWD_KERNEL, D, k, tile, x.device)
    key = (B, T, D, k, bf16, tile, x.device.index)
    if key not in _workspaces:
        with torch.cuda.device(x.device):
            _workspaces[key] = bwd_workspace(B, T, D, k, bf16, tile)
    work = torch.empty(_workspaces[key], dtype=torch.uint8, device=x.device)
    inter = torch.empty(12 * B * T * D, dtype=torch.float32,
                        device=x.device) if intermediates and bf16 else None
    dx = torch.empty_like(x)
    grads = [torch.empty_like(w) for w in weights]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(BWD_KERNEL)(
            x.data_ptr(), dy.data_ptr(), lengths.data_ptr(),
            *(w.data_ptr() for w in weights), work.data_ptr(), dx.data_ptr(),
            *(g.data_ptr() for g in grads),
            None if inter is None else inter.data_ptr(), B, T, D, k,
            int(bf16), tile, float(eps), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(
            BWD_KERNEL, err))
    BWD_LAUNCHES += 1
    if intermediates:
        return (dx, *grads), (bwd_intermediates(inter, B, T, D) if bf16
                              else bwd_intermediates(work, B, T, D, 8))
    return (dx, *grads)


class _ConformerConv(torch.autograd.Function):
    """The fused module under autograd: only x, the lengths and the
    weights are kept; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, lengths, eps, *weights):
        if x.device.type == "cpu":
            y = conformer_conv_module_plain(x, lengths, *weights, eps=eps)
        else:
            y = conformer_conv_module_cuda(x, lengths, *weights, eps=eps)
        ctx.eps = eps
        ctx.save_for_backward(x, lengths, *weights)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, lengths, *weights = ctx.saved_tensors
        bwd = conformer_conv_module_bwd_plain if x.device.type == "cpu" \
            else conformer_conv_module_cuda_bwd
        dx, *grads = bwd(x, lengths, *weights, dy.contiguous(), eps=ctx.eps)
        return (dx, None, None, *grads)


def conformer_conv_module(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                          pw1_bias, dw_kernel, dw_bias, ln2_scale, ln2_bias,
                          pw2_kernel, pw2_bias,
                          eps: float = EPS) -> torch.Tensor:
    """The fused conv module: the plain versions for a CPU tensor, the
    kernels for a CUDA one; differentiable in x and the ten weights."""
    args = (ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
            ln2_scale, ln2_bias, pw2_kernel, pw2_bias)
    if x.device.type == "cpu":
        lengths = lengths.to(x.device)
    else:
        x = x.contiguous()
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        args = tuple(w.float().contiguous() for w in args)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x,) + args):
        return _ConformerConv.apply(x, lengths, float(eps), *args)
    if x.device.type == "cpu":
        return conformer_conv_module_plain(x, lengths, *args, eps=eps)
    return conformer_conv_module_cuda(x, lengths, *args, eps=eps)
