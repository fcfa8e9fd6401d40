"""What the GRU and LSTM scan wrappers (``ops/gru_scan.py``,
``ops/lstm_scan.py``) share: their input checks, the CTA layout, the
launch of their forward and backward kernels (``csrc/{gru,lstm}_scan_
{fwd,bwd}.cu``) through ctypes, the plain versions' stacking of their
steps, the state before each step (:func:`prev_states`) and whether a
call must keep what its backward needs (:func:`needs_grad`).

Each kernel runs the whole recurrence of one direction of one layer, or
its reverse-time backward, in one cooperative launch of ``H / units``
CTAs that meet at a grid-wide barrier every step (``csrc/rnn_scan.cuh``,
``csrc/rnn_scan_bwd.cuh``). Before a launch, :func:`check_fits` asks the
kernel's own ``*_resources`` entry whether a CTA of it fits an SM at that
width and dtype, and raises ValueError where it does not (the fp32 LSTM
at H = 1280, forward and backward, and at H = 1152 backward: their fp32
copies of W_h pass a CTA's shared memory). The launcher checks with the
occupancy API that the whole grid fits on the card at once and raises
:class:`NotCoResident` otherwise; nothing is launched then. In bf16 both
directions run on the tensor cores in clusters of two CTAs, in fp32 on
the CUDA cores; a failed build or launch raises, and nothing falls back
to another design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

# the kernels' status codes besides CUDA's own
_NOT_CO_RESIDENT = -2
_BAD_UNITS = -3
_TOO_MUCH_SMEM = -4
MAX_UNITS = 10
# the one width under 128 that the fp32 kernels take: a row of h is one
# 256-byte chunk (``kChunkBytes`` in csrc/rnn_scan.cuh), the grid 64 CTAs
# of one unit; the bf16 kernels' warps need H = 128 U
NARROW_FP32 = 64
_fns = {}
_fits = {}


class NotCoResident(RuntimeError):
    """The scan's grid cannot be resident on the card all at once."""


def takes(H: int, dtype: torch.dtype) -> bool:
    """Whether the scan kernels' warps take width H in ``dtype``: H a
    multiple of 128 (H = 128 U), or, in fp32 only, ``NARROW_FP32``."""
    return H % 128 == 0 or (dtype == torch.float32 and H == NARROW_FP32)


def units_per_cta(H: int) -> int:
    """Hidden units per CTA: H / 128, so that the grid is 128 CTAs, one
    per SM of an H100, whatever H; one at ``NARROW_FP32``."""
    return max(H // 128, 1)


def check_inputs(x_proj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                 lengths: torch.Tensor, gates: int) -> None:
    """Raise ValueError unless x_proj is (B, T, gates * H) bf16 or fp32 on
    a CUDA device with H % 128 == 0 and H <= 128 * MAX_UNITS (or, in
    fp32, H = ``NARROW_FP32``), and W_h, h0 and lengths are (H, gates *
    H), (B, H) and (B,) on its device."""
    if x_proj.device.type != "cuda":
        raise ValueError("no scan kernel for device {}".format(
            x_proj.device))
    if x_proj.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("x_proj must be bf16 or fp32, got {}".format(
            x_proj.dtype))
    if x_proj.dim() != 3 or x_proj.shape[2] % gates:
        raise ValueError("x_proj must be (B, T, {} H), got {}".format(
            gates, tuple(x_proj.shape)))
    B, _, GH = x_proj.shape
    H = GH // gates
    if not takes(H, x_proj.dtype) or not 0 < H <= 128 * MAX_UNITS:
        raise ValueError("the scan kernels take H a multiple of 128 up to "
                         "{} (and {} in fp32), got {}".format(
                             128 * MAX_UNITS, NARROW_FP32, H))
    for name, t, shape in (("wh", wh, (H, GH)), ("h0", h0, (B, H)),
                           ("lengths", lengths, (B,))):
        if t.device != x_proj.device:
            raise ValueError("{} is on {}, x_proj on {}".format(
                name, t.device, x_proj.device))
        if tuple(t.shape) != shape:
            raise ValueError("{} must be {}, got {}".format(
                name, shape, tuple(t.shape)))


def stack_steps(steps, empty, like: torch.Tensor) -> torch.Tensor:
    """The plain versions' per-step (B, ...) tensors stacked on the time
    axis; a new tensor of shape ``empty`` like ``like`` when T is 0."""
    return torch.stack(steps, dim=1) if steps else like.new_zeros(empty)


def needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate a call on ``tensors``: then
    the forward keeps the residuals its backward needs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def backward_steps(T: int, reverse: bool) -> range:
    """The times t in the order the backward visits them: the forward's
    order reversed, so t walks down for a forward cell and up for a
    reverse one."""
    return range(T) if reverse else range(T - 1, -1, -1)


def prev_states(seq: torch.Tensor, init: torch.Tensor,
                lengths: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(B, T, H): the state each step t started from, in the forward's
    order: ``seq[:, t_prev]`` with t_prev = t - 1 (t + 1 for a reverse
    cell) where 0 <= t_prev < T and t_prev < length, else ``init``.

    ``seq`` is the forward's ys (the LSTM's cs for c): zero past each
    length (ys) or not the carried state (cs), so a reverse row's first
    valid step (t = length - 1) takes ``init``, never ``seq`` (C15, C16).
    The kernels and the plain backward versions take the same rule."""
    B, T = seq.shape[:2]
    t_prev = torch.arange(T, device=seq.device) + (1 if reverse else -1)
    valid = (t_prev >= 0) & (t_prev < T)
    valid = valid[None, :] & (t_prev[None, :] < lengths[:, None])
    gathered = seq[:, t_prev.clamp(0, max(T - 1, 0))]
    return torch.where(valid[:, :, None], gathered,
                       init.to(seq.dtype)[:, None, :])


def _kernel(name: str, n_ptr: int, n_int: int, n_float: int):
    fn = _fns.get(name)
    if fn is None:
        from ..kernels import build
        fn = getattr(build.load(name), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_float] * n_float + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def resources(name: str, H: int, bf16: bool = True) -> tuple:
    """(dynamic shared memory in bytes, CTAs an SM holds, CTAs resident
    at once in the launch's clusters) of the kernel that the entry
    ``name`` (``gru_scan_fwd`` ...) launches at width H, from its C entry
    ``<name>_resources``, the last two 0 where a CTA's shared memory
    passes what an SM gives one; nothing is launched."""
    from ..kernels import build
    fn = getattr(build.load(name), name + "_resources")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(H, units_per_cta(H), int(bf16), out)
    if err != 0:
        raise RuntimeError("{}_resources failed: CUDA error {}".format(name,
                                                                     err))
    return tuple(out)


def check_fits(name: str, H: int, dtype: torch.dtype,
               device: torch.device) -> None:
    """Raise ValueError, naming the width, unless a CTA of the kernel that
    the entry ``name`` launches at width H in ``dtype`` fits an SM of
    ``device``, as the kernel's own ``<name>_resources`` entry reports (no
    launch; remembered per entry, width, dtype and device), and unless
    the kernels take H in ``dtype`` (:func:`takes`)."""
    if not takes(H, dtype):
        raise ValueError("{} takes no {} scan at H = {}: its warps need H "
                         "a multiple of 128".format(name, str(dtype)[6:], H))
    key = (name, H, dtype, device.index)
    if key not in _fits:
        with torch.cuda.device(device):
            _fits[key] = resources(name, H, dtype == torch.bfloat16)
    smem, per_sm, _ = _fits[key]
    if per_sm == 0:
        raise ValueError(
            "{} takes no {} scan at H = {}: a CTA of it needs {} bytes of "
            "shared memory, more than an SM of {} gives one".format(
                name, str(dtype)[6:], H, smem,
                torch.cuda.get_device_name(device)))


def launch(name: str, tensors: Sequence, ints: Sequence[int],
           floats: Sequence[float] = ()) -> None:
    """Call the C entry ``name`` with the tensors' pointers (None for a
    null one), the ints, the floats and the current stream; raise on any
    status but 0."""
    dev = next(t.device for t in tensors if t is not None)
    fn = _kernel(name, len(tensors), len(ints), len(floats))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors],
                 *ints, *floats, stream)
    if err == _NOT_CO_RESIDENT:
        raise NotCoResident(
            "{}: a grid of {} CTAs cannot be resident on {} at once, which "
            "its grid-wide barrier needs".format(
                name, ints[2] // ints[3], torch.cuda.get_device_name(dev)))
    if err == _TOO_MUCH_SMEM:
        raise ValueError("{}: a CTA at H = {} needs more shared memory than "
                         "an SM gives one".format(name, ints[2]))
    if err == _BAD_UNITS:
        raise ValueError("{}: {} units per CTA is not built (1 to {})".format(
            name, ints[3], MAX_UNITS))
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(name, err))
