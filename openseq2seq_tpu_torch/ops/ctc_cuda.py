"""CTC on the hand-written CUDA kernels ``csrc/ctc_alpha_fwd.cu`` and
``csrc/ctc_beta_bwd.cu``.

Port of ``openseq2seq_tpu/ops/ctc_pallas.py``: the TPU kernels
``_alpha_kernel`` (the forward, with or without its checkpoints) and
``_beta_chunk_kernel`` (the backward), reached from ``ctc_loss_pallas``
through its custom VJP. As there, ``log_softmax`` runs outside the
kernels and the infeasible-row mask and the batch mean stay in the
caller.

:func:`ctc_nll_cuda` is differentiable with respect to the log-probs (a
``torch.autograd.Function``). For CUDA tensors its forward launches
``ctc_alpha_fwd``, with the alpha lattice when a gradient is needed, and
its backward launches ``ctc_beta_bwd`` and scales by the incoming
gradient (``_ctc_bwd``, ``ctc_pallas.py:427-435``). Anything the kernels
do not take raises. For CPU tensors it runs the plain versions,
:func:`ctc_nll_plain` and :func:`ctc_nll_grad_plain` (``ops/ctc.py``).
There is no other fallback.

``LAUNCHES`` counts launches of the forward kernel and ``BWD_LAUNCHES``
of the backward kernel, so a run can show that its main path went
through them.
"""
from __future__ import annotations

import ctypes

import torch

from . import ctc
from .ctc import ctc_nll as ctc_nll_plain
from .ctc import ctc_nll_grad as ctc_nll_grad_plain

LAUNCHES = 0
BWD_LAUNCHES = 0
KERNEL = "ctc_alpha_fwd"
BWD_KERNEL = "ctc_beta_bwd"
_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ..kernels import build
        fn = getattr(build.load(name), name)
        n_ptr = 6 if name == KERNEL else 7
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, x, dtype, ndim, device):
    if x.device != device:
        raise ValueError("{} is on {}, logprobs on {}".format(
            name, x.device, device))
    if x.dtype != dtype:
        raise ValueError("{} must be {}, got {}".format(name, dtype, x.dtype))
    if x.dim() != ndim:
        raise ValueError("{} must have {} dims, got shape {}".format(
            name, ndim, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def _check_inputs(logprobs, logit_lengths, labels, label_lengths, blank_id):
    if logprobs.device.type != "cuda":
        raise ValueError("no CTC kernel for device {}".format(
            logprobs.device))
    dev = logprobs.device
    _check("logprobs", logprobs, torch.float32, 3, dev)
    _check("logit_lengths", logit_lengths, torch.int32, 1, dev)
    _check("labels", labels, torch.int32, 2, dev)
    _check("label_lengths", label_lengths, torch.int32, 1, dev)
    B, T, V = logprobs.shape
    if labels.shape[0] != B or logit_lengths.shape[0] != B or \
            label_lengths.shape[0] != B:
        raise ValueError("batch sizes differ: logprobs {}, logit_lengths {}, "
                         "labels {}, label_lengths {}".format(
                             B, logit_lengths.shape[0], labels.shape[0],
                             label_lengths.shape[0]))
    if T < 1 or not 0 <= blank_id < V:
        raise ValueError("need T >= 1 and 0 <= blank_id < V; got T={}, "
                         "blank_id={}, V={}".format(T, blank_id, V))


def _launch(name, args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                              else a for a in args], stream)
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(name, err))


def alpha_fwd(logprobs, logit_lengths, labels, label_lengths, blank_id,
              with_lattice: bool):
    """Launch ``ctc_alpha_fwd``: (B,) NLL, and the (B, T, 2L+1) alpha
    lattice or None. Only frames t < length and states s < 2 len + 1 of
    the lattice are written."""
    global LAUNCHES
    _check_inputs(logprobs, logit_lengths, labels, label_lengths, blank_id)
    B, T, V = logprobs.shape
    L = labels.shape[1]
    dev = logprobs.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    lattice = torch.empty((B, T, 2 * L + 1), dtype=torch.float32,
                          device=dev) if with_lattice else None
    if B == 0:
        return nll, lattice
    _launch(KERNEL, (logprobs, logit_lengths, labels, label_lengths, nll,
                     lattice if with_lattice else None, B, T, V, L,
                     blank_id))
    LAUNCHES += 1
    return nll, lattice


def beta_bwd(logprobs, logit_lengths, labels, label_lengths, blank_id, nll,
             lattice):
    """Launch ``ctc_beta_bwd``: the (B, T, V) gradient of the NLL with
    respect to the log-probs, from the forward's NLL and lattice."""
    global BWD_LAUNCHES
    _check_inputs(logprobs, logit_lengths, labels, label_lengths, blank_id)
    B, T, V = logprobs.shape
    L = labels.shape[1]
    dev = logprobs.device
    _check("nll", nll, torch.float32, 1, dev)
    _check("lattice", lattice, torch.float32, 3, dev)
    if nll.shape[0] != B or tuple(lattice.shape) != (B, T, 2 * L + 1):
        raise ValueError("nll {} or lattice {} does not fit logprobs {}"
                         .format(tuple(nll.shape), tuple(lattice.shape),
                                 (B, T, V)))
    dlp = torch.empty((B, T, V), dtype=torch.float32, device=dev)
    if B == 0:
        return dlp
    _launch(BWD_KERNEL, (logprobs, logit_lengths, labels, label_lengths,
                         nll, lattice, dlp, B, T, V, L, blank_id))
    BWD_LAUNCHES += 1
    return dlp


class _CTCNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logprobs, logit_lengths, labels, label_lengths,
                blank_id):
        ctx.blank_id = blank_id
        need_grad = ctx.needs_input_grad[0]
        if logprobs.device.type == "cpu":
            if not need_grad:
                return ctc_nll_plain(logprobs, logit_lengths, labels,
                                     label_lengths, blank_id)
            nll, dlp = ctc_nll_grad_plain(logprobs, logit_lengths, labels,
                                          label_lengths, blank_id)
            ctx.save_for_backward(dlp)
            return nll
        nll, lattice = alpha_fwd(logprobs, logit_lengths, labels,
                                 label_lengths, blank_id, need_grad)
        if need_grad:
            ctx.save_for_backward(logprobs, logit_lengths, labels,
                                  label_lengths, nll, lattice)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        saved = ctx.saved_tensors
        if len(saved) == 1:
            dlp = saved[0]
        else:
            dlp = beta_bwd(*saved[:4], ctx.blank_id, *saved[4:])
        return dlp * grad_nll[:, None, None], None, None, None, None


def ctc_nll_cuda(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor,
                 blank_id: int) -> torch.Tensor:
    """(B,) negative log likelihood from (B, T, V) fp32 log-probs, with
    int32 (B,) logit lengths, (B, L) labels and (B,) label lengths;
    differentiable with respect to the log-probs."""
    if logprobs.device.type not in ("cpu", "cuda"):
        raise ValueError("no CTC kernel for device {}".format(
            logprobs.device))
    return _CTCNLL.apply(logprobs, logit_lengths, labels, label_lengths,
                         blank_id)


def ctc_loss_cuda(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: int = -1,
                  ignore_longer_outputs_than_inputs: bool = True,
                  average_across_batch: bool = True) -> torch.Tensor:
    """Drop-in for :func:`ops.ctc.ctc_loss` with the recursions on the
    kernels (the port of ``ctc_loss_pallas``); gradients flow through
    ``log_softmax`` to the logits, whatever their dtype."""
    blank = ctc.resolve_blank(blank_id, logits.shape[2])
    nll = ctc_nll_cuda(ctc.log_probs(logits).contiguous(), logit_lengths,
                       labels, label_lengths, blank)
    return ctc.reduce_nll(nll, logit_lengths, labels, label_lengths,
                          ignore_longer_outputs_than_inputs,
                          average_across_batch)
