"""Post-training int8 quantization (port of
``openseq2seq_tpu/serving/quantize.py``, the counterpart of the
reference's TF-TRT int8 calibration, ``open_seq2seq/models/model.py:
559-696``).

  * **Weight-only int8** (:func:`quantize_params_int8`,
    :func:`dequantize_params`): every kernel or embedding of at least
    ``min_size`` elements is stored as int8 with an fp32 scale per channel
    of its last flax axis (symmetric absmax). That axis is the output
    channel of a flax dense or conv kernel, which is axis 0 of the port's
    ``Dense`` weight (out, in) or conv weight, but the width of an
    embedding table, so quantization works on the flax-layout view of the
    parameters (``convert.flax_from_state_dict``, named by
    ``convert.flax_path``) with the JAX package's own numpy arithmetic,
    pattern, ``min_size`` and report. :func:`export_inference_fn_int8`
    puts the int8 tensors into the artifact in the port's layout and
    dequantizes them inside the program, so the artifact is smaller than
    the fp one, as the JAX package's is.
  * **Activation calibration** (:func:`calibrate_activations`): each
    module's output absmax over calibration batches (the statistic TF-TRT's
    calibrator collects), recorded with forward hooks, keyed by port module
    name.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .export import export_program, load_exported

DEFAULT_QUANT_PATTERN = r"(kernel|embedding)$"
_SKIP_NDIM = 1          # biases and norms stay fp32


def flax_params(params) -> Dict[str, Any]:
    """The flax-layout parameter tree of ``params``: an ``nn.Module`` (its
    state dict through ``convert.flax_from_state_dict``) or a tree that
    already is one."""
    if isinstance(params, torch.nn.Module):
        from ..convert import flax_from_state_dict, layer_norm_modules
        return flax_from_state_dict(params.state_dict(),
                                    layer_norm_modules(params))["params"]
    return params


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"int8", "scale"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and not _is_qleaf(v):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _map(tree, fn, prefix=()):
    return {k: (_map(v, fn, prefix + (k,))
                if isinstance(v, dict) and not _is_qleaf(v)
                else fn(prefix + (k,), v)) for k, v in tree.items()}


def quantize_params_int8(params, pattern: str = DEFAULT_QUANT_PATTERN,
                         min_size: int = 4096):
    """Symmetric int8 quantization, per channel of the last flax axis, of
    the leaves of ``params`` (an ``nn.Module`` or a flax-layout tree) whose
    flax path matches ``pattern``, of more than one axis and at least
    ``min_size`` elements. Returns (qparams, report): ``qparams`` mirrors
    the flax tree with each quantized leaf ``{"int8": int8 array, "scale":
    fp32 scales}``, ``report`` maps each quantized leaf's path
    (``dec/ffns_0/filter/kernel``) to its largest quantization error."""
    rx = re.compile(pattern)
    report = {}

    def q(path, leaf):
        name = "/".join(str(p) for p in path)
        arr = np.asarray(leaf)
        if (not rx.search(name) or arr.ndim <= _SKIP_NDIM or
                arr.size < min_size or
                not np.issubdtype(arr.dtype, np.floating)):
            return leaf
        scale = np.max(np.abs(arr), axis=tuple(range(arr.ndim - 1)),
                       keepdims=True) / 127.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        q8 = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        report[name] = float(np.max(np.abs(q8 * scale - arr)))
        return {"int8": q8, "scale": scale}

    return _map(flax_params(params), q), report


def dequantize_params(qparams, dtype: torch.dtype = torch.float32):
    """Inverse of :func:`quantize_params_int8` (lossy): each quantized
    leaf as the tensor int8 * scale in ``dtype``, the other leaves as they
    are."""
    def dq(_, leaf):
        if _is_qleaf(leaf):
            return (torch.from_numpy(np.asarray(leaf["int8"])).to(dtype) *
                    torch.from_numpy(np.asarray(leaf["scale"])).to(dtype))
        return leaf
    return _map(qparams, dq)


def port_layout(qparams) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The quantized leaves of ``qparams`` in the port's layout: {port
    parameter name: (int8 tensor, fp32 scale tensor)}, each laid out as
    ``convert.state_dict_from_flax`` lays out its parameter (a dense
    kernel's int8 (out, in) with scales (out, 1)), so that int8 * scale is
    the dequantized parameter, bit for bit."""
    from ..convert import _param_to_torch
    out = {}
    for path, leaf in _leaves(qparams):
        if _is_qleaf(leaf):
            name, q8 = _param_to_torch(path, leaf["int8"])
            _, scale = _param_to_torch(path, leaf["scale"])
            out[name] = (torch.from_numpy(q8.astype(np.int8)),
                         torch.from_numpy(scale))
    return out


class Int8Program(torch.nn.Module):
    """The forward of ``module`` with its quantized parameters held as
    int8 buffers and scales, dequantized inside the program
    (``torch.func.functional_call``); ``module`` holds an empty
    placeholder in place of each. With ``act_ranges`` the calibrated
    layers run in int8 (``int8_exec``), their weights the program's int8
    buffers."""

    def __init__(self, module: torch.nn.Module,
                 qweights: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 train: bool, act_ranges: Optional[Dict[str, float]]):
        super().__init__()
        params = dict(module.named_parameters())
        self.names = sorted(qweights)
        self.dtypes = [params[n].dtype for n in self.names]
        device = next(iter(params.values())).device
        self.module = _with_placeholders(module, self.names)
        for i, name in enumerate(self.names):
            q8, scale = qweights[name]
            self.register_buffer("q{}".format(i), q8.to(device))
            self.register_buffer("s{}".format(i), scale.to(device))
        self.train_flag = bool(train)
        self.act_ranges = act_ranges

    def forward(self, batch: Dict[str, Any]):
        from .int8_exec import make_int8_interceptor
        q = [(getattr(self, "q{}".format(i)), getattr(self, "s{}".format(i)))
             for i in range(len(self.names))]
        weights = {name: (q8.float() * scale).to(dtype) for name, (q8, scale),
                   dtype in zip(self.names, q, self.dtypes)}
        interceptor = make_int8_interceptor(self.act_ranges or {},
                                            dict(zip(self.names, q)))
        with interceptor(self.module):
            return torch.func.functional_call(
                self.module, weights, (batch,),
                {"train": self.train_flag, "generator": None})


def _with_placeholders(module: torch.nn.Module, names) -> torch.nn.Module:
    """A copy of ``module`` that shares every parameter and buffer with it
    but holds an empty placeholder for each parameter in ``names``."""
    skip = set(names)
    memo = {id(p): p for n, p in module.named_parameters() if n not in skip}
    memo.update({id(b): b for b in module.buffers()})
    for n, p in module.named_parameters():
        if n in skip:
            memo[id(p)] = torch.nn.Parameter(
                torch.empty(0, dtype=p.dtype, device=p.device),
                requires_grad=False)
    return copy.deepcopy(module, memo)


def export_inference_fn_int8(model, state, example_batch,
                             path: Optional[str] = None,
                             pattern: str = DEFAULT_QUANT_PATTERN,
                             min_size: int = 4096,
                             act_ranges: Optional[Dict[str, float]] = None,
                             train: bool = False):
    """Like ``export.export_inference_fn``, with int8 weights: the
    artifact holds each quantized parameter as its int8 tensor and scales
    (:func:`port_layout`), which the program dequantizes, and every other
    parameter as it is. Returns (blob_bytes, report).

    ``act_ranges``: per-layer input absmax from
    ``int8_exec.calibrate_dense_inputs``. When given, the calibrated
    layers run as int8 x int8 -> int32 products in the program, on the
    artifact's int8 weights where they are quantized (the TF-TRT
    int8-engine equivalent). ``train`` as in ``export_inference_fn``."""
    qparams, report = quantize_params_int8(state.module, pattern,
                                           min_size=min_size)
    program = Int8Program(state.module, port_layout(qparams), train,
                          act_ranges)
    meta = {"device": str(model.device), "train": bool(train)}
    blob = export_program(program, example_batch, model.device, meta, path)
    return blob, report


def load_exported_int8(blob_or_path) -> Callable:
    """Rehydrate an int8 artifact into a ``callable(batch)``."""
    return load_exported(blob_or_path)


def calibrate_activations(model, state, batches: Iterable,
                          filter_fn: Optional[Callable[[str], bool]] = None
                          ) -> Dict[str, float]:
    """Each module's output absmax over the calibration batches (the
    statistic TF-TRT's int8 calibrator gathers), ``train=False``: {port
    module name: absmax} for every module with a floating-point output
    (the largest over its tensors where it returns several), ``filter_fn``
    choosing among the names."""
    from ..models.model import to_device_batch
    from .int8_exec import calibration_generator
    ranges: Dict[str, float] = {}

    def record(name):
        def hook(_, args, output):
            mx = _absmax(output)
            if mx is not None:
                ranges[name] = max(ranges.get(name, 0.0), mx)
        return hook

    handles = [m.register_forward_hook(record(name))
               for name, m in state.module.named_modules()
               if name and (filter_fn is None or filter_fn(name))]
    try:
        with torch.no_grad():
            for batch in batches:
                state.module(to_device_batch(batch, model.device),
                             train=False,
                             generator=calibration_generator(model.device))
    finally:
        for h in handles:
            h.remove()
    return ranges


def _absmax(output) -> Optional[float]:
    """The largest |value| over the floating-point tensors of a module's
    output (tensors, lists, tuples and dicts of them), or None."""
    if isinstance(output, torch.Tensor):
        if output.is_floating_point() and output.numel():
            return float(output.detach().float().abs().max())
        return None
    items = output.values() if isinstance(output, dict) else \
        output if isinstance(output, (list, tuple)) else ()
    found = [m for m in (_absmax(o) for o in items) if m is not None]
    return max(found) if found else None
