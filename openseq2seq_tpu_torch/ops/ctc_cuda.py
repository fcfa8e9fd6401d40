"""CTC on the hand-written CUDA kernels ``csrc/ctc_alpha_fwd.cu`` and
``csrc/ctc_beta_bwd.cu`` (on ``csrc/ctc.cuh``).

Port of ``openseq2seq_tpu/ops/ctc_pallas.py``: the TPU kernels
``_alpha_kernel`` (the forward, with or without its checkpoints) and
``_beta_chunk_kernel`` (the backward), reached from ``ctc_loss_pallas``
through its custom VJP. As there, ``log_softmax`` runs outside the
kernels and the infeasible-row mask and the batch mean stay in the
caller.

:func:`ctc_nll_cuda` is differentiable with respect to the log-probs (a
``torch.autograd.Function``). For CUDA tensors its forward launches
``ctc_alpha_fwd``, with the alpha lattice when a gradient is needed, and
its backward calls ``ctc_beta_bwd`` (two launches: the beta recursion,
which writes each state's posterior, then the vocabulary scatter) and
scales by the incoming gradient (``_ctc_bwd``, ``ctc_pallas.py:427-435``).
Anything the kernels do not take raises, a label length whose CTA does
not fit an SM too (:func:`check_fits`, from the kernels' own
``*_resources`` entries), before any launch. For CPU tensors it runs the
plain versions, :func:`ctc_nll_plain` and :func:`ctc_nll_grad_plain`
(``ops/ctc.py``). There is no other fallback.

``LAUNCHES`` counts calls of the forward kernel and ``BWD_LAUNCHES``
calls of the backward's pair of launches, so a run can show that its main
path went through them.

:func:`readings` is the check that the card runs hold the kernels to,
and :func:`planted_faults` the wrong kernels it must refuse, built from
the plain versions.
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
# the frames a chunk that the recursions stage in shared memory at every
# shape whose chunk of 32 fits an SM (at V = 29, L up to 410):
# csrc/ctc.cuh kMaxChunk
CHUNK = 32
# the checks' tolerances, fp32 on both sides: the NLL of feasible rows
# (relative), d log-probs and the backward's posteriors (absolute), and
# a live frame's posteriors summing to 1 (d log-probs summing to -1)
NLL_RTOL = 1e-5
DLP_ATOL = 1e-5
POST_ATOL = 1e-5
SUM_ATOL = 1e-4

_P, _I = ctypes.c_void_p, ctypes.c_int
_RESOURCES = ([_I, _I, ctypes.POINTER(_I)], _I)
# C entry -> (library, argument types, result type)
_SIGNATURES = {
    # lp, logit_len, labels, label_len, nll, alpha; B, T, V, L, blank;
    # stream
    KERNEL: (KERNEL, [_P] * 6 + [_I] * 5 + [_P], _I),
    # lp, logit_len, labels, label_len, nll; B, T, V, L, blank; stream
    "ctc_alpha_floor": (KERNEL, [_P] * 5 + [_I] * 5 + [_P], _I),
    # L, V, out
    KERNEL + "_resources": (KERNEL,) + _RESOURCES,
    # lp, logit_len, labels, label_len, nll, alpha, post, work, dlp; B, T,
    # V, L, blank; stream
    BWD_KERNEL: (BWD_KERNEL, [_P] * 9 + [_I] * 5 + [_P], _I),
    BWD_KERNEL + "_resources": (BWD_KERNEL,) + _RESOURCES,
}
_fns = {}
_fits = {}        # (L, V, device index) -> ctc_resources(L, V)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ..kernels import build
        lib, argtypes, restype = _SIGNATURES[name]
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def ctc_resources(L: int, V: int) -> dict:
    """The kernels' resources at label length L and vocabulary V, from
    their C entries (nothing launched; needs a CUDA device): for "fwd"
    (``ctc_alpha_fwd``) and "bwd" (the backward's recursion) a tuple
    (threads, states a thread, frames a chunk, dynamic shared memory
    in bytes, CTAs an SM), for "scatter" (threads, frames a CTA, warps a
    CTA, dynamic shared memory, CTAs an SM). 0 CTAs: it does not fit."""
    out = {}
    for key, entry, n in (("fwd", KERNEL, 5), ("bwd", BWD_KERNEL, 10)):
        buf = (ctypes.c_int * n)()
        err = _kernel(entry + "_resources")(L, V, buf)
        if err != 0:
            raise RuntimeError("{}_resources failed: CUDA error {}".format(
                entry, err))
        out[key] = tuple(buf[:5])
        if n == 10:
            out["scatter"] = tuple(buf[5:])
    return out


def check_fits(L: int, V: int, device: torch.device,
               backward: bool) -> None:
    """Raise ValueError, naming the shape, where a CTA of the forward (or,
    with ``backward``, of the backward's launches) at (L, V) does not fit
    an SM of ``device``, as ``ctc_resources`` reports it (remembered);
    nothing is launched."""
    key = (L, V, device.index)
    if key not in _fits:
        with torch.cuda.device(device):
            _fits[key] = ctc_resources(L, V)
    for part in ("bwd", "scatter") if backward else ("fwd",):
        res = _fits[key][part]
        if res[4] == 0:
            raise ValueError(
                "the CTC {} takes no CTA at L = {}, V = {}: {} threads and "
                "{} bytes of shared memory do not fit an SM of {} (the "
                "recursions hold at most 4 states a thread, L <= 2047)"
                .format({"fwd": "forward", "bwd": "backward's recursion",
                         "scatter": "backward's scatter"}[part], L, V,
                        res[0], res[3], torch.cuda.get_device_name(device)))


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
    check_fits(L, V, dev, backward=False)
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


def alpha_floor(logprobs, logit_lengths, labels, label_lengths, blank_id):
    """Launch ``ctc_alpha_floor``, the forward's recursion with each
    state's emission held in a register and no lattice: the per-frame
    floor of ``scripts_torch/bench_ctc.py``. Its NLL means nothing and it
    is no path's: it is not counted."""
    _check_inputs(logprobs, logit_lengths, labels, label_lengths, blank_id)
    B, T, V = logprobs.shape
    L = labels.shape[1]
    check_fits(L, V, logprobs.device, backward=False)
    nll = torch.empty((B,), dtype=torch.float32, device=logprobs.device)
    _launch("ctc_alpha_floor", (logprobs, logit_lengths, labels,
                                label_lengths, nll, B, T, V, L, blank_id))
    return nll


def beta_bwd(logprobs, logit_lengths, labels, label_lengths, blank_id, nll,
             lattice, posteriors: bool = False):
    """Call ``ctc_beta_bwd`` (the beta recursion, then the vocabulary
    scatter): the (B, T, V) gradient of the NLL with respect to the
    log-probs, from the forward's NLL and lattice; with ``posteriors``
    also the first launch's (B, T, 2L+1) posteriors, written only where
    ``ctc.ctc_posteriors`` may be non-zero (t < length, s < 2 len + 1,
    feasible rows)."""
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
    check_fits(L, V, dev, backward=True)
    post = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=dev)
    work = torch.empty((B, L + V + 3), dtype=torch.int32, device=dev)
    dlp = torch.empty((B, T, V), dtype=torch.float32, device=dev)
    if B > 0:
        _launch(BWD_KERNEL, (logprobs, logit_lengths, labels, label_lengths,
                             nll, lattice, post, work, dlp, B, T, V, L,
                             blank_id))
        BWD_LAUNCHES += 1
    return (dlp, post) if posteriors else dlp


def plain_results(logprobs, logit_lengths, labels, label_lengths,
                  blank_id) -> dict:
    """The plain versions' results: "nll", "lattice", "post" (the
    posteriors) and "dlp", by ``ctc.ctc_nll_lattice``,
    ``ctc.ctc_posteriors`` and ``ctc.ctc_scatter``."""
    nll, lattice = ctc.ctc_nll_lattice(logprobs, logit_lengths, labels,
                                       label_lengths, blank_id)
    post = ctc.ctc_posteriors(logprobs, logit_lengths, labels, label_lengths,
                              blank_id, nll, lattice)
    return {"nll": nll, "lattice": lattice, "post": post,
            "dlp": ctc.ctc_scatter(post, labels, label_lengths, blank_id,
                                   logprobs.shape[2])}


def readings(got: dict, want: dict, logit_lengths, labels,
             label_lengths) -> dict:
    """The CTC checks as readings, each an error over its tolerance, so
    that a reading above 1 refuses: "nll", the largest relative error of
    ``got["nll"]`` on feasible rows over ``NLL_RTOL``; "dlp", the largest
    absolute error of ``got["dlp"]`` over ``DLP_ATOL``; "zeros", 0 where
    d log-probs are exactly 0 on infeasible rows and past each length,
    else inf; "sums", the largest |sum over v of d log-probs + 1| on a
    live frame of a feasible row over ``SUM_ATOL``; and, where ``got`` has
    "post", "post", the largest absolute error of the posteriors over
    ``POST_ATOL`` on the states ``want["post"]`` may hold (t < length, s <
    2 len + 1, feasible rows)."""
    T = got["dlp"].shape[1]
    dev = got["dlp"].device
    feasible = ctc.feasible_rows(logit_lengths, labels, label_lengths)
    live = torch.arange(T, device=dev)[None, :] < logit_lengths[:, None]
    err = (got["nll"] - want["nll"]).abs() / want["nll"].abs()
    out = {"nll": float(err[feasible].max()) / NLL_RTOL
           if bool(feasible.any()) else 0.0,
           "dlp": float((got["dlp"] - want["dlp"]).abs().max()) / DLP_ATOL}
    zeros = bool(torch.all(got["dlp"][~feasible] == 0)) and \
        bool(torch.all(got["dlp"][~live] == 0))
    out["zeros"] = 0.0 if zeros else float("inf")
    sums = got["dlp"].sum(dim=2)[feasible[:, None] & live]
    out["sums"] = float((sums + 1).abs().max()) / SUM_ATOL \
        if sums.numel() else 0.0
    if "post" in got:
        S = got["post"].shape[2]
        states = torch.arange(S, device=dev)[None, :] < \
            (2 * label_lengths.long() + 1)[:, None]
        where = (feasible[:, None, None] & live[:, :, None] &
                 states[:, None, :])
        out["post"] = float((got["post"] - want["post"]).abs()[where].max()) \
            / POST_ATOL if bool(where.any()) else 0.0
    return out


def planted_faults(logprobs, logit_lengths, labels, label_lengths,
                   blank_id, plain: dict) -> dict:
    """Wrong kernels that :func:`readings` must refuse, from the plain
    versions' results ``plain`` (:func:`plain_results`) on these inputs:
    name -> results ("nll", "dlp", "post"), each with one fault planted:

    * "emission t+1 at a chunk edge": the forward uses frame CHUNK + 1's
      emissions at frame CHUNK (the last frame of its first chunk), the
      backward right on its lattice;
    * "lattice frame from its neighbour": the backward reads each row's
      lattice frame len - 1 - CHUNK (the first of its second chunk) from
      the frame after it;

    (these two only where a feasible row reaches frame CHUNK + 1)
    * "repeated symbol's state left out": the scatter leaves out the
      second occurrence of a row's first repeated symbol (absent where no
      feasible row repeats one);
    * "rows zeroed but row 1": d log-probs 0 on every row but row 1."""
    B, T, V = logprobs.shape
    args = (logit_lengths, labels, label_lengths, blank_id)
    faults = {}
    feasible = ctc.feasible_rows(logit_lengths, labels, label_lengths)
    reach = torch.clamp(logit_lengths, max=T)[feasible]
    if not bool((reach > CHUNK + 1).any()):
        reach = None
    if reach is not None:
        lp = logprobs.clone()
        lp[:, CHUNK] = logprobs[:, CHUNK + 1]
        nll, lattice = ctc.ctc_nll_lattice(lp, *args)
        post = ctc.ctc_posteriors(logprobs, *args, nll, lattice)
        faults["emission t+1 at a chunk edge"] = {
            "nll": nll, "post": post,
            "dlp": ctc.ctc_scatter(post, labels, label_lengths, blank_id, V)}
    if reach is not None:
        lattice = plain["lattice"].clone()
        for b in range(B):
            t = int(logit_lengths[b]) - 1 - CHUNK
            if 0 <= t and t + 1 < T:
                lattice[b, t] = plain["lattice"][b, t + 1]
        post = ctc.ctc_posteriors(logprobs, *args, plain["nll"], lattice)
        faults["lattice frame from its neighbour"] = {
            "nll": plain["nll"], "post": post,
            "dlp": ctc.ctc_scatter(post, labels, label_lengths, blank_id,
                                   V)}
    for b in range(B):
        row = labels[b, :int(label_lengths[b])].tolist()
        again = [j for j, v in enumerate(row) if v in row[:j]]
        if bool(feasible[b]) and int(logit_lengths[b]) > 0 and again:
            post = plain["post"].clone()
            post[b, :, 2 * again[0] + 1] = 0.0
            faults["repeated symbol's state left out"] = {
                "nll": plain["nll"], "post": plain["post"],
                "dlp": ctc.ctc_scatter(post, labels, label_lengths,
                                       blank_id, V)}
            break
    dlp = plain["dlp"].clone()
    rows = torch.arange(B, device=dlp.device) != 1
    dlp[rows] = 0.0
    faults["rows zeroed but row 1"] = {"nll": plain["nll"],
                                       "post": plain["post"], "dlp": dlp}
    return faults


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
