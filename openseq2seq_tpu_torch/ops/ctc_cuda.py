"""CTC forward on the hand-written CUDA kernel ``csrc/ctc_alpha_fwd.cu``.

Port of the forward half of ``openseq2seq_tpu/ops/ctc_pallas.py``: the
TPU kernel ``_alpha_kernel`` (``with_ckpt=False``), reached from
``ctc_loss_pallas``. As there, ``log_softmax`` runs outside the kernel
and the infeasible-row mask and the batch mean stay in the caller.

:func:`ctc_nll_cuda` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs the plain version,
:func:`ctc_nll_plain` (the recursion of ``ops/ctc.py``). There is no
other fallback. The backward (the TPU kernel ``_beta_chunk_kernel``) is
not ported yet, so a log-prob tensor that requires grad is refused.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import ctc
from .ctc import ctc_nll as ctc_nll_plain

LAUNCHES = 0
KERNEL = "ctc_alpha_fwd"
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ..kernels import build
        fn = build.load(KERNEL).ctc_alpha_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def ctc_nll_cuda(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor,
                 blank_id: int) -> torch.Tensor:
    """(B,) negative log likelihood from (B, T, V) fp32 log-probs, with
    int32 (B,) logit lengths, (B, L) labels and (B,) label lengths."""
    global LAUNCHES
    if logprobs.requires_grad:
        raise NotImplementedError(
            "the CTC backward kernel lands with training")
    if logprobs.device.type == "cpu":
        return ctc_nll_plain(logprobs, logit_lengths, labels, label_lengths,
                             blank_id)
    if logprobs.device.type != "cuda":
        raise ValueError("no CTC kernel for device {}".format(
            logprobs.device))
    dev = logprobs.device
    _check("logprobs", logprobs, torch.float32, 3, dev)
    _check("logit_lengths", logit_lengths, torch.int32, 1, dev)
    _check("labels", labels, torch.int32, 2, dev)
    _check("label_lengths", label_lengths, torch.int32, 1, dev)
    B, T, V = logprobs.shape
    L = labels.shape[1]
    if labels.shape[0] != B or logit_lengths.shape[0] != B or \
            label_lengths.shape[0] != B:
        raise ValueError("batch sizes differ: logprobs {}, logit_lengths {}, "
                         "labels {}, label_lengths {}".format(
                             B, logit_lengths.shape[0], labels.shape[0],
                             label_lengths.shape[0]))
    if T < 1 or not 0 <= blank_id < V:
        raise ValueError("need T >= 1 and 0 <= blank_id < V; got T={}, "
                         "blank_id={}, V={}".format(T, blank_id, V))
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return nll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(logprobs.data_ptr(), logit_lengths.data_ptr(),
                        labels.data_ptr(), label_lengths.data_ptr(),
                        nll.data_ptr(), B, T, V, L, blank_id, stream)
    if err != 0:
        raise RuntimeError("ctc_alpha_fwd launch failed: CUDA error {}"
                           .format(err))
    LAUNCHES += 1
    return nll


def ctc_loss_cuda(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: int = -1,
                  ignore_longer_outputs_than_inputs: bool = True,
                  average_across_batch: bool = True) -> torch.Tensor:
    """Drop-in for :func:`ops.ctc.ctc_loss` with the recursion on the
    kernel (the port of ``ctc_loss_pallas``)."""
    blank = ctc.resolve_blank(blank_id, logits.shape[2])
    nll = ctc_nll_cuda(ctc.log_probs(logits).contiguous(), logit_lengths,
                       labels, label_lengths, blank)
    return ctc.reduce_nll(nll, logit_lengths, labels, label_lengths,
                          ignore_longer_outputs_than_inputs,
                          average_across_batch)
