"""TDNN encoder — Wave2Letter+ / Jasper / QuartzNet family (port of
``openseq2seq_tpu/encoders/tdnn_encoder.py``).

Same config contract: a ``convnet_layers`` list of block specs ``{type,
repeat, kernel_size, stride, num_channels, padding, dilation,
dropout_keep_prob, residual, residual_dense}``, the normalization switch
(``batch_norm``, ``layer_norm``, ``instance_norm`` or None), sequence
masking (``use_conv_mask``) and Jasper's dense residuals. Module and
parameter names follow the flax module's (``conv{l}_{r}``, a separable
block's ``conv{l}_{r}_dw`` and ``conv{l}_{r}_pw``, ``norm{l}_{r}``,
``res{l}_{s}``, ``resnorm{l}_{s}``) so that ``convert.py`` maps one onto
the other by name.

Kept from the JAX package, each a trap when porting:
  * SAME padding is XLA's: out = ceil(T / stride) and the odd pad goes on
    the right, for any stride and dilation (torch's ``padding="same"``
    refuses stride 2, so the pad is explicit);
  * batch norm takes eps 1e-3 and flax's ``momentum=0.90`` becomes
    torch's 0.10, and normalizes in fp32 before casting back; in training
    it updates its running variance with the biased batch variance, as
    flax does (torch's own update uses the unbiased one);
  * the time mask is applied before every sub-layer and at the end, and
    each strided conv maps lengths to ceil(len / stride).

In training, dropout (``parts/dropout.py``, honouring the model's
``dropout_bits``) and the stochastic block drop (``drop_block_prob``: one
Bernoulli per block per step, the block's output is then its residual
sum alone) draw from the ``torch.Generator`` passed to ``forward``.

Block types: ``conv1d`` and ``sep_conv1d`` (QuartzNet's: a depthwise
conv, one group a channel, with the block's stride and dilation, then a
1x1 pointwise conv to ``num_channels``, each with its bias), both with
``padding: SAME``, and ``tcn`` (the causal conv, :class:`CausalConv1d`,
whatever its ``padding``, as in the JAX package). Another type, or
``padding: VALID`` (the JAX module maps lengths as SAME does whatever
the padding, so its lengths would be wrong), raises. Normalizations: the
batch norm below; ``layer_norm``, flax's ``LayerNorm`` with epsilon
``bn_epsilon`` (fp32 statistics and parameters, output in the compute
dtype); ``instance_norm``, no parameters, the biased mean and variance
over time of the whole padded tensor (unmasked, as in the JAX module),
rounded to the activations' dtype as jnp.mean and jnp.var round them,
then normalized in that dtype; None, no norm. The residual projections'
norms follow the same switch. The module takes and
returns (B, T, C), as the JAX package does, and keeps that layout
inside: each conv runs as a 2-D conv over a (B, C, 1, T) channels-last
view of it, so cuDNN takes its NHWC implicit-GEMM kernels. In NCW
layout its weight gradient fell back to a legacy kernel that made
Jasper's train step several times slower (NVIDIA H100 80GB HBM3,
700.00 W: one 768-channel k=25 conv's fwd+bwd took 18.1 ms in NCW
against 2.0 ms channels-last).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from ..parts.dropout import bernoulli, dropout

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": F.gelu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def resolve_activation(fn) -> Callable:
    if callable(fn):
        return fn
    if isinstance(fn, str):
        if fn not in ACTIVATIONS:
            raise ValueError("Unknown activation '{}'".format(fn))
        return ACTIVATIONS[fn]
    raise ValueError("activation_fn must be callable or a name")


def _mask_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero features at padded time positions: x (B, T, C), lengths (B,)."""
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < \
        lengths[:, None]
    return x * mask[:, :, None].to(x.dtype)


def _out_length(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    # SAME padding: ceil(len / stride)
    return (lengths + stride - 1) // stride


def same_padding(length: int, kernel: int, stride: int,
                 dilation: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) for a conv over ``length`` frames."""
    span = (kernel - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + span - length, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Module):
    """Conv1d with XLA's SAME padding and a bias (flax ``nn.Conv``'s
    default; none with ``use_bias`` False), computing in ``dtype`` from
    the stored params; (B, T, C) in and out. The weight is stored (out,
    in, k), as torch's conv1d keeps it. The bias is added after the conv
    as flax rounds it (C26: under bf16 the conv's output rounded, then the
    sum; fp32 keeps the fused form). ``groups`` is flax's
    ``feature_group_count``: ``in_ch`` groups make the depthwise conv of a
    separable block, its weight (in_ch, 1, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dilation: int, dtype: torch.dtype, kernel_init,
                 generator: torch.Generator, use_bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        kernel_init(self.weight, generator)
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.groups = groups
        self.dtype = dtype

    def padding(self, length: int) -> Tuple[int, int]:
        """(low, high) zeros around ``length`` frames."""
        return same_padding(length, self.kernel, self.stride, self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.padding(x.shape[1])
        if lo != hi:
            x, lo = F.pad(x, (0, 0, lo, hi)), 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        fused = self.dtype == torch.float32 or b is None
        # (B, T, C) contiguous is (B, C, 1, T) in channels-last order
        y = F.conv2d(x.to(self.dtype).permute(0, 2, 1).unsqueeze(2),
                     self.weight.unsqueeze(2).to(
                         dtype=self.dtype, memory_format=torch.channels_last),
                     b if fused else None, (1, self.stride), (0, lo),
                     (1, self.dilation), self.groups
                     ).squeeze(2).permute(0, 2, 1)
        return y if fused else y + b


class CausalConv1d(SameConv1d):
    """flax ``nn.Conv(padding="CAUSAL")`` (and the reference's
    ``parts/cnns/tcn.py``): ``(k - 1) * d`` zeros on the left, none on the
    right, then the strided, dilated VALID conv, so output t sees inputs
    up to t only; ceil(T / stride) frames out. Otherwise
    :class:`SameConv1d`, the bf16 rounding of the bias included."""

    def padding(self, length: int) -> Tuple[int, int]:
        return (self.kernel - 1) * self.dilation, 0


class BatchNorm(nn.BatchNorm1d):
    """Batch norm over the channels of (B, T, C) that normalizes in fp32
    and returns ``dtype``, as flax's BatchNorm does under a bf16 compute
    dtype.

    In training it normalizes with the biased batch statistics and
    updates the running ones by hand as flax does,
    ``ra = (1 - momentum) * ra + momentum * batch_stat`` with the biased
    variance (torch's ``momentum`` is flax's ``1 - momentum``); torch's
    own update would use the unbiased variance."""

    def __init__(self, channels: int, momentum: float, eps: float,
                 dtype: torch.dtype):
        super().__init__(channels, eps=eps, momentum=momentum)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1]).float()
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight.float(), self.bias.float(), False,
                             0.0, self.eps)
            return y.to(self.dtype).reshape(shape)
        y = F.batch_norm(x, None, None, self.weight.float(),
                         self.bias.float(), True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y.to(self.dtype).reshape(shape)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps)`` over the channels inside the
    ``_Norm`` switch: fp32 statistics and parameters, output in ``dtype``.
    The flax twin's inner ``LayerNorm_0`` folds into this module
    (``flax_inner``)."""
    flax_inner = "LayerNorm_0"

    def __init__(self, channels: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class InstanceNorm(nn.Module):
    """The ``instance_norm`` branch of the JAX ``_Norm``: (x - mean) *
    rsqrt(var + eps) over time, per row and channel, of the whole padded
    tensor. jnp.mean and jnp.var of bf16 sum in fp32 (the variance about
    the fp32 mean) and round their results to bf16; the rest runs in the
    activations' dtype, one rounding an operation."""

    def __init__(self, eps: float):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        var, mean = torch.var_mean(x.float(), dim=1, keepdim=True,
                                   correction=0)
        return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) +
                                                    self.eps)


class NoNorm(nn.Module):
    """``normalization: None``: the input as it is."""

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return x


def make_norm(kind, channels: int, momentum: float, eps: float,
              dtype: torch.dtype) -> nn.Module:
    """The JAX ``_Norm`` switch; ``momentum`` is flax's (the running
    average's decay)."""
    if kind == "batch_norm":
        # torch's momentum is the weight of the new batch
        return BatchNorm(channels, 1.0 - momentum, eps, dtype)
    if kind == "layer_norm":
        return LayerNorm(channels, eps, dtype)
    if kind == "instance_norm":
        return InstanceNorm(eps)
    if kind is None:
        return NoNorm()
    raise ValueError("Unknown normalization '{}'".format(kind))


class TDNNNet(nn.Module):
    """The module behind :class:`TDNNEncoder`: (B, T, F) features and
    (B,) lengths in, (B, T', C) outputs and (B,) lengths out."""

    def __init__(self, in_features: int, convnet_layers, activation_fn,
                 dropout_keep_prob: float, bn_momentum: float,
                 bn_epsilon: float, use_conv_mask: bool,
                 drop_block_prob: float, drop_block_index: int,
                 dropout_bits: int, dtype: torch.dtype, kernel_init,
                 generator: torch.Generator, normalization="batch_norm"):
        super().__init__()
        self.activation_fn = activation_fn
        self.use_conv_mask = use_conv_mask
        self.drop_block_prob = drop_block_prob
        self.drop_block_index = drop_block_index
        self.dropout_bits = dropout_bits
        self.dtype = dtype
        self.plan = []        # per block: what forward() walks
        norm = lambda c: make_norm(  # noqa: E731
            normalization, c, bn_momentum, bn_epsilon, dtype)
        conv = lambda i, o, k, s, d, cls=SameConv1d, g=1: cls(  # noqa: E731
            i, o, k, s, d, dtype, kernel_init, generator, groups=g)
        ch_in = in_features
        residual_channels = []    # widths of saved block inputs (dense)
        for li, spec in enumerate(convnet_layers, start=1):
            kind = spec["type"]
            if kind != "tcn" and (kind not in ("conv1d", "sep_conv1d") or
                                  spec.get("padding", "SAME") != "SAME"):
                raise NotImplementedError(
                    "only conv1d and sep_conv1d with SAME padding and tcn "
                    "are ported; got type={} padding={}".format(
                        kind, spec.get("padding")))
            ch = spec["num_channels"]
            k, s = spec["kernel_size"][0], spec["stride"][0]
            d = spec.get("dilation", [1])[0]
            residual = spec.get("residual", False)
            dense = spec.get("residual_dense", False)
            sources = []
            if residual:
                if dense:
                    residual_channels.append(ch_in)
                    sources = list(residual_channels)
                else:
                    sources = [ch_in]
            for r in range(1, spec.get("repeat", 1) + 1):
                name = "conv{}_{}".format(li, r)
                if kind == "sep_conv1d":
                    self.add_module(name + "_dw", conv(ch_in, ch_in, k, s, d,
                                                       g=ch_in))
                    self.add_module(name + "_pw", conv(ch_in, ch, 1, 1, 1))
                else:
                    self.add_module(name, conv(
                        ch_in, ch, k, s, d,
                        CausalConv1d if kind == "tcn" else SameConv1d))
                self.add_module("norm{}_{}".format(li, r), norm(ch))
                ch_in = ch
            for si, src_ch in enumerate(sources):
                self.add_module("res{}_{}".format(li, si),
                                conv(src_ch, ch, 1, 1, 1))
                self.add_module("resnorm{}_{}".format(li, si), norm(ch))
            self.plan.append({
                "index": li, "repeat": spec.get("repeat", 1), "stride": s,
                "separable": kind == "sep_conv1d",
                "keep": spec.get("dropout_keep_prob", dropout_keep_prob),
                "residual": residual, "dense": dense})
        self.out_features = ch_in

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool,
                generator: torch.Generator = None):
        """``generator`` draws dropout masks and block drops in training
        (on ``x``'s device)."""
        m = self._modules
        x = x.to(self.dtype)                               # (B, T, C)
        residuals = []            # saved block inputs (dense topology)
        for p in self.plan:
            li = p["index"]
            if p["residual"]:
                if p["dense"]:
                    residuals.append(x)
                    sources = list(residuals)
                else:
                    sources = [x]
            for r in range(1, p["repeat"] + 1):
                if self.use_conv_mask:
                    x = _mask_time(x, lengths)
                name = "conv{}_{}".format(li, r)
                if p["separable"]:
                    x = m[name + "_pw"](m[name + "_dw"](x))
                else:
                    x = m[name](x)
                x = m["norm{}_{}".format(li, r)](x, train)
                if p["stride"] > 1:
                    lengths = _out_length(lengths, p["stride"])
                if p["residual"] and r == p["repeat"]:
                    res_sum = None
                    for si, src in enumerate(sources):
                        proj = m["res{}_{}".format(li, si)](src)
                        proj = m["resnorm{}_{}".format(li, si)](proj, train)
                        res_sum = proj if res_sum is None else res_sum + proj
                    if train and self.drop_block_prob > 0.0:
                        drop = bernoulli(self.drop_block_prob, generator,
                                         x.device)
                        x = torch.where(drop, res_sum, x + res_sum)
                    elif not train and self.drop_block_index == li - 1:
                        x = res_sum
                    else:
                        x = x + res_sum
                x = self.activation_fn(x)
                if train:
                    x = dropout(x, p["keep"], generator, self.dropout_bits)
        if self.use_conv_mask:
            x = _mask_time(x, lengths)
        return x, lengths


class TDNNEncoderModule(nn.Module):

    def __init__(self, net: TDNNNet):
        super().__init__()
        self.net = net
        self.out_features = net.out_features

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        x, lengths = input_dict["source_tensors"][:2]
        outputs, out_len = self.net(x, lengths, train, generator)
        return {"outputs": outputs, "src_length": out_len}


class TDNNEncoder(Encoder):
    """Config wrapper, same schema as the JAX package's."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "dropout_keep_prob": float,
            "convnet_layers": list,
            "activation_fn": None,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "data_format": ["channels_first", "channels_last"],
            "normalization": [None, "batch_norm", "layer_norm",
                              "instance_norm"],
            "bn_momentum": float,
            "bn_epsilon": float,
            "use_conv_mask": bool,
            "drop_block_prob": float,
            "drop_block_index": int,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> TDNNEncoderModule:
        from ..parts.initializers import resolve_initializer
        p = self._params
        net = TDNNNet(
            in_features=in_features,
            convnet_layers=p["convnet_layers"],
            activation_fn=resolve_activation(p["activation_fn"]),
            dropout_keep_prob=p["dropout_keep_prob"],
            normalization=p.get("normalization", "batch_norm"),
            bn_momentum=p.get("bn_momentum", 0.90),
            bn_epsilon=p.get("bn_epsilon", 1e-3),
            use_conv_mask=p.get("use_conv_mask", False),
            drop_block_prob=p.get("drop_block_prob", 0.0),
            drop_block_index=p.get("drop_block_index", -1),
            dropout_bits=32 if self._model is None
            else self._model.params.get("dropout_bits", 32),
            dtype=self.compute_dtype,
            kernel_init=resolve_initializer(p.get("initializer"),
                                            p.get("initializer_params")),
            generator=generator,
        )
        return TDNNEncoderModule(net)
