"""The Conformer's convolution module on the hand-written CUDA kernel
``csrc/conformer_conv_fwd.cu`` (kernel B6, forward).

Port of ``openseq2seq_tpu/ops/conformer_pallas.py``'s forward (``_fused``
with ``_compute_forward``, ``:122-155`` and ``:325-352``; entry
``conformer_conv_module``, ``:426-441``): the layer-norm variant of
``encoders/conformer_encoder._ConvModule`` as one function,

    y = pw2(swish(LN2(dwconv_k(mask(GLU(pw1(LN1(x))))))))

with that kernel's precision: an fp32 chain, the layer norms' fast
variance E[x^2] - E[x]^2 (eps 1e-6; not ``F.layer_norm``'s two-pass one),
the two pointwise products on operands rounded to x's type with fp32
accumulation (bf16 for bf16 x, fp32 otherwise), the depthwise taps in
fp32, and y in x's type. Dropout and the residual add are the caller's.

:func:`supported` keeps what belongs to the function: the layer-norm
variant only (batch norm's running statistics are training state). The
TPU kernel's VMEM budget has no counterpart; the CUDA kernel's own limits
are ``kernel_supports``: D a multiple of 64 from 64 to 512 (Conformer-M's
256 and -L's 512) and 1 <= k <= 63 (the recipes' 31).

For a CPU tensor :func:`conformer_conv_module` runs the plain version
:func:`conformer_conv_module_plain`; for a CUDA tensor it launches the
kernel (its products on the tensor cores for bf16, on the CUDA cores for
fp32) or raises, outside those limits too. There is no other fallback,
and no backward yet: on the card it refuses inputs that need a gradient.
``LAUNCHES`` counts calls that launch the kernel (its two launches, see
the source, count once).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
KERNEL = "conformer_conv_fwd"
EPS = 1e-6
MAX_DIM = 512
MAX_KERNEL_SIZE = 63
_fn = []


def _kernel():
    if not _fn:
        from ..kernels import build
        fn = build.load(KERNEL).conformer_conv_fwd
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def supported(conv_norm: str) -> bool:
    """Whether the fused module computes this variant: layer norm only."""
    return conv_norm == "layer_norm"


def kernel_supports(D: int, k: int) -> bool:
    """The CUDA kernel's limits on the width D and the depthwise taps k."""
    return D % 64 == 0 and 64 <= D <= MAX_DIM and 1 <= k <= MAX_KERNEL_SIZE


def _layer_norm(x32, scale, bias, eps):
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def conformer_conv_module_plain(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                                pw1_bias, dw_kernel, dw_bias, ln2_scale,
                                ln2_bias, pw2_kernel, pw2_bias,
                                eps: float = EPS) -> torch.Tensor:
    """The kernel's function in torch ops at its precision. x (B, T, D);
    lengths (B,); pw1_kernel (D, 2D), dw_kernel (k, D), pw2_kernel (D, D)
    and the norms' and biases' vectors, fp32. Returns (B, T, D) in x's
    dtype."""
    B, T, D = x.shape
    k = dw_kernel.shape[0]
    mxu = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def product(a, w):
        # operands rounded to the product type, exact fp32 products
        return a.to(mxu).float() @ w.to(mxu).float()

    h0 = _layer_norm(x.float(), ln1_scale, ln1_bias, eps)
    a = product(h0, pw1_kernel) + pw1_bias.float()
    u = a[..., :D] * torch.sigmoid(a[..., D:])
    live = torch.arange(T, device=x.device)[None, :] < \
        lengths.to(x.device)[:, None]
    u = torch.where(live[..., None], u, 0.0)
    # the taps over the row only: zeros outside [0, T), XLA's SAME offsets
    halo = (k - 1) // 2
    up = F.pad(u, (0, 0, halo, k - 1 - halo))
    c = torch.zeros_like(u)
    for j in range(k):
        c = c + dw_kernel[j].float() * up[:, j:j + T]
    n = _layer_norm(c + dw_bias.float(), ln2_scale, ln2_bias, eps)
    y = product(n * torch.sigmoid(n), pw2_kernel) + pw2_bias.float()
    return y.to(x.dtype)


def conformer_conv_module_cuda(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                               pw1_bias, dw_kernel, dw_bias, ln2_scale,
                               ln2_bias, pw2_kernel, pw2_bias,
                               eps: float = EPS) -> torch.Tensor:
    """Launch ``conformer_conv_fwd``; raises on what it does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError("no conformer conv kernel for device {}".format(
            x.device))
    weights = (ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
               ln2_scale, ln2_bias, pw2_kernel, pw2_bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x,) + weights):
        raise NotImplementedError("the conformer conv module backward "
                                  "(kernel B6's _bwd_kernel) is not ported "
                                  "yet")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3 or \
            not x.is_contiguous():
        raise ValueError("x must be a contiguous bf16 or fp32 (B, T, D) "
                         "tensor; got {} {}".format(x.dtype, tuple(x.shape)))
    B, T, D = x.shape
    k = dw_kernel.shape[0]
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
    u = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), lengths.data_ptr(),
                        *(w.data_ptr() for w in weights), u.data_ptr(),
                        y.data_ptr(), B, T, D, k,
                        int(x.dtype == torch.bfloat16), float(eps), stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(KERNEL,
                                                                    err))
    LAUNCHES += 1
    return y


def conformer_conv_module(x, lengths, ln1_scale, ln1_bias, pw1_kernel,
                          pw1_bias, dw_kernel, dw_bias, ln2_scale, ln2_bias,
                          pw2_kernel, pw2_bias,
                          eps: float = EPS) -> torch.Tensor:
    """The fused conv module: the plain version for a CPU tensor, the
    kernel for a CUDA one."""
    args = (ln1_scale, ln1_bias, pw1_kernel, pw1_bias, dw_kernel, dw_bias,
            ln2_scale, ln2_bias, pw2_kernel, pw2_bias)
    if x.device.type == "cpu":
        return conformer_conv_module_plain(x, lengths, *args, eps=eps)
    return conformer_conv_module_cuda(
        x.contiguous(), lengths.to(device=x.device,
                                   dtype=torch.int32).contiguous(),
        *(w.float().contiguous() for w in args), eps=eps)
