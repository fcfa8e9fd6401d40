"""int8-activation execution for serving (port of
``openseq2seq_tpu/serving/int8_exec.py``, the counterpart of TF-TRT
running its int8 engines after calibration, reference
``open_seq2seq/models/model.py:559-696``).

Which layers: every module whose flax twin is ``nn.Dense`` or a
``DenseGeneral`` with a 2-D kernel (``int8_exec.py:46-59``), that is the
port's two dense classes, ``parts/transformer/common.Dense`` (the
transformer's q/k/v/qkv/out and FFN projections) and
``decoders/fc_decoders.Dense``; the 3-D ``DenseGeneral`` kernels (the
Conformer's and Transformer-XL's attention) are raw parameters of their
blocks and stay fp, as they do in the JAX package.

While :func:`make_int8_interceptor`'s context is open, every call of a
calibrated layer, the beam's cached decode steps among them, runs
:func:`int8_dense` in place of the layer's forward, following
``_int8_dense`` (``int8_exec.py:99-121``): the input quantized against its
static range, ``x_scale`` = float64 ``max(absmax, 1e-12) / 127`` rounded to
fp32, ``round`` half to even (as ``jnp.round``), clipped to [-127, 127];
the weight quantized per output channel from the fp32 master weight (or
taken pre-quantized, the artifact's path); an int8 x int8 -> int32
product (``torch._int_mm``; on CUDA it wants more than 16 rows and a
depth and width that are multiples of 8, so the operands are padded with
zero rows and columns, which leaves every sum as it is); the rescale
``acc * (x_scale * w_scale)`` and the fp32 bias in fp32; the result in the
dtype of the input as the layer received it. Given the same quantized
input, the output is exact up to the fp32 rescale:
:func:`int8_dense_plain` computes the same sums in float64 and must give
the same bits. Layers without a range fall through to their fp forward,
as TF-TRT's per-op engine selection does.

Ranges are keyed by the port's module names (``dec.ffns_0.filter``);
:func:`jax_key_map` turns the JAX package's keys (``dec/ffns_0/filter``)
into them.

Entry points: :func:`calibrate_dense_inputs` (each calibrated layer's
input absmax over calibration batches, TF-TRT's calibrator statistic),
:func:`int8_apply_fn` (a ``fn(batch)`` that serves with int8 activations
wherever a range exists) and ``quantize.export_inference_fn_int8(...,
act_ranges=...)``, which puts this path into the exported artifact.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# torch._int_mm's shapes on CUDA: more than this many rows, and depth and
# width multiples of PAD_TO
MIN_ROWS = 16
PAD_TO = 8

# calls of int_mm in this process, a trace's among them (a loaded
# program runs its ``aten._int_mm`` nodes instead)
CALLS = 0


def _dense_classes() -> tuple:
    from ..decoders.fc_decoders import Dense as FCDense
    from ..parts.transformer.common import Dense
    return Dense, FCDense


def int8_layers(module: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The layers of ``module`` that can run in int8, by name."""
    classes = _dense_classes()
    return {name: m for name, m in module.named_modules()
            if isinstance(m, classes)}


def jax_key_map(module: torch.nn.Module) -> Dict[str, str]:
    """{the JAX package's module path: the port's module name} for the
    int8 layers of ``module``, from the flax name of each one's weight
    (``convert.flax_path``)."""
    from ..convert import _norm_modules, flax_path, layer_norm_modules
    norms = _norm_modules([n for n, _ in module.named_buffers()])
    lns = layer_norm_modules(module)
    return {"/".join(flax_path(name + ".weight", norms, lns)[:-1]): name
            for name in int8_layers(module)}


def x_scale(absmax: float) -> float:
    """The input's scale as the JAX package takes it: the float64
    ``max(absmax, 1e-12) / 127`` rounded to fp32."""
    return float(torch.tensor(max(float(absmax), 1e-12) / 127.0,
                              dtype=torch.float32))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A weight (out, in) quantized per output channel: (int8 (out, in),
    fp32 scale (out,)), from its fp32 values."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=1) / _divisor(127.0, w.device),
                        min=1e-12)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _divisor(value: float, device) -> torch.Tensor:
    """``value`` as an fp32 tensor on ``device``: a division by it is the
    true division JAX computes (CUDA takes a division by a host scalar as
    a product with its reciprocal, which may round otherwise)."""
    return torch.full((1,), value, dtype=torch.float32, device=device)


def quantize_input(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x quantized against ``scale``, int8, in x's shape."""
    return torch.clamp(torch.round(x.float() / _divisor(scale, x.device)),
                       -127, 127).to(torch.int8)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 times b_t (N, K) int8 transposed -> int32 (M, N), by
    ``torch._int_mm``, the operands padded with zeros to its shapes;
    counted in ``CALLS``."""
    global CALLS
    CALLS += 1
    M, K = a.shape
    N = b_t.shape[0]
    rows, depth, width = max(M, MIN_ROWS + 1), _pad_to(K, PAD_TO), \
        _pad_to(N, PAD_TO)
    if (rows, depth) != (M, K):
        a = torch.nn.functional.pad(a, (0, depth - K, 0, rows - M))
    if (width, depth) != (N, K):
        b_t = torch.nn.functional.pad(b_t, (0, depth - K, 0, width - N))
    acc = torch._int_mm(a, b_t.t())
    return acc[:M, :N]


def _exact_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a b_t^T in float64, exact for int8 operands (every sum is below
    127^2 K < 2^53)."""
    return a.double() @ b_t.double().t()


def _int8_affine(module, x, absmax, qweight, qscale, product):
    if qweight is None:
        qweight, qscale = quantize_weight(module.weight)
    s = x_scale(absmax)
    acc = product(quantize_input(x, s).reshape(-1, x.shape[-1]), qweight)
    y = acc.float() * (_divisor(s, x.device) * qscale.reshape(-1).float())
    if module.bias is not None:
        y = y + module.bias.float()
    return y.reshape(x.shape[:-1] + (qweight.shape[0],)).to(x.dtype)


def int8_dense(module: torch.nn.Module, x: torch.Tensor, absmax: float,
               qweight: Optional[torch.Tensor] = None,
               qscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer ``module`` (weight (out, in), bias or None) on x in int8,
    the product on :func:`int_mm`: see the module's docstring.
    ``qweight`` (out, in) int8 and ``qscale`` (out elements, any shape)
    are the pre-quantized weight, when given."""
    return _int8_affine(module, x, absmax, qweight, qscale, int_mm)


def int8_dense_plain(module: torch.nn.Module, x: torch.Tensor,
                     absmax: float, qweight: Optional[torch.Tensor] = None,
                     qscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`int8_dense`'s plain version: the integer sums in float64,
    then the same fp32 rescale and bias; the same bits as
    :func:`int8_dense`'s."""
    return _int8_affine(module, x, absmax, qweight, qscale, _exact_mm)


class Int8Interceptor:
    """``interceptor(module)`` is a context in which every calibrated
    layer of ``module`` (a range above 0 under its name in ``ranges``)
    runs :func:`int8_dense`; ``qweights`` maps a layer's weight name
    (``dec.ffns_0.filter.weight``, relative to ``module``) to its
    pre-quantized (int8 weight (out, in), scale) where the caller has
    one."""

    def __init__(self, ranges: Dict[str, float],
                 qweights: Optional[Dict[str, Tuple[torch.Tensor,
                                                    torch.Tensor]]] = None):
        self.ranges = dict(ranges)
        self.qweights = qweights or {}

    @contextlib.contextmanager
    def __call__(self, module: torch.nn.Module):
        patched = []
        try:
            for name, m in int8_layers(module).items():
                absmax = self.ranges.get(name) or 0.0
                if absmax > 0.0:
                    q = self.qweights.get(name + ".weight", (None, None))
                    m.forward = _int8_forward(m, absmax, *q)
                    patched.append(m)
            yield
        finally:
            for m in patched:
                del m.forward


def _int8_forward(m, absmax, qweight, qscale):
    def forward(x):
        return int8_dense(m, x, absmax, qweight, qscale)
    return forward


def make_int8_interceptor(ranges: Dict[str, float], qparams=None
                          ) -> Int8Interceptor:
    """The interceptor serving the layers calibrated in ``ranges`` (port
    module names) in int8. ``qparams``: the pre-quantized weights in the
    port's layout (``quantize.port_layout`` of
    ``quantize.quantize_params_int8``'s tree, the artifact's path);
    without them each call quantizes the layer's fp32 weight."""
    return Int8Interceptor(ranges, qparams)


def _no_record_in_decode(module: torch.nn.Module, flag: list):
    """Wrap the ``decode`` method of each submodule that has one (the
    autoregressive decoders), so that ``flag[0]`` is set while it runs."""
    wrapped = []
    for m in module.modules():
        decode = getattr(m, "decode", None)
        if callable(decode) and "decode" not in vars(m):
            def run(*args, _decode=decode, **kwargs):
                flag[0] = True
                try:
                    return _decode(*args, **kwargs)
                finally:
                    flag[0] = False
            m.decode = run
            wrapped.append(m)
    return wrapped


def calibration_generator(device) -> torch.Generator:
    """The dropout generator of a calibration or serving forward, seeded
    0 as the JAX package passes ``PRNGKey(0)``."""
    return torch.Generator(device=device).manual_seed(0)


def calibrate_dense_inputs(model, state, batches: Iterable,
                           train: bool = False) -> Dict[str, float]:
    """Each int8 layer's input absmax over the calibration batches,
    keyed by port module name: the inputs each layer consumes, the
    quantity the int8 input quantizer needs (``calibrate_activations``
    records module outputs).

    Calls inside an autoregressive decode are not recorded, as the JAX
    package's recorder skips those of its traced decode loop; the same
    layers are calibrated by the teacher-forced pass. ``train=True``
    calibrates the teacher-forced path alone; use it with every dropout
    rate 0 (serving configs), else the ranges include dropout's 1/keep
    scaling."""
    from ..models.model import to_device_batch
    module = state.module
    ranges: Dict[str, float] = {}
    in_decode = [False]

    def recorder(name):
        def hook(_, args):
            if not in_decode[0]:
                mx = float(args[0].float().abs().max())
                ranges[name] = max(ranges.get(name, 0.0), mx)
        return hook

    handles = [m.register_forward_pre_hook(recorder(name))
               for name, m in int8_layers(module).items()]
    wrapped = _no_record_in_decode(module, in_decode)
    try:
        with torch.no_grad():
            for batch in batches:
                module(to_device_batch(batch, model.device), train=train,
                       generator=calibration_generator(model.device))
    finally:
        for h in handles:
            h.remove()
        for m in wrapped:
            del m.decode
    return ranges


def int8_apply_fn(model, state, ranges: Dict[str, float],
                  train: bool = False) -> Callable:
    """``fn(batch)``: ``state.module``'s forward with int8 activations in
    every layer calibrated in ``ranges``, without autograd. ``train`` as
    in ``export.export_inference_fn``: True gives the teacher-forced
    scoring forward."""
    from ..models.model import to_device_batch
    interceptor = make_int8_interceptor(ranges)

    def serve(batch):
        with torch.no_grad(), interceptor(state.module):
            return state.module(to_device_batch(batch, model.device),
                                train=train,
                                generator=calibration_generator(
                                    model.device))
    return serve
