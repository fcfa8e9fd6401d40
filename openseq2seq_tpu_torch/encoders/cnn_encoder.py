"""Generic CNN encoder built from a config's layer list (port of
``openseq2seq_tpu/encoders/cnn_encoder.py``; AlexNet and the CIFAR
network).

Layers are dicts, ``{"type": "conv2d" | "max_pool" | "avg_pool" |
"dense" | "flatten" | "dropout" | "batch_norm", ...}`` (the aliases
``conv``, ``fc`` and ``bn`` too), or ``(name, params)`` tuples, whose
``max_pooling2d`` and ``average_pooling2d`` become ``max_pool`` and
``avg_pool`` (``_norm_spec``). ``cnn_layers`` then ``fc_layers`` form one
list, and a layer with parameters is named ``"{type}_{index}"`` over it,
counting from 1 (``conv2d_1``, ``dense_7``), as the flax module names
it, so that ``convert.py`` maps one onto the other.

As in the JAX package: the activations are (B, H, W, C), channels last;
convs carry a bias (added as flax rounds it, C26) and default to SAME
padding, XLA's offsets (``ds2_encoder.SameConv2d``), pools default to
VALID (``resnet_encoder.max_pool``, ``avg_pool``); a dense layer flattens
what it is given; batch norm defaults to momentum 0.9 and eps 1e-4 in
fp32 (``tdnn_encoder.BatchNorm``); each layer's ``activation`` is one of
``tdnn_encoder.resolve_activation``'s names or a callable; dropout draws
in training from the step's generator with the model's ``dropout_bits``
(``parts/dropout.py``); the output is flattened to (B, -1).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Sequence

import torch
import torch.nn as nn

from .ds2_encoder import SameConv2d
from .encoder import Encoder
from .resnet_encoder import avg_pool, max_pool
from .tdnn_encoder import BatchNorm, resolve_activation
from ..decoders.fc_decoders import Dense
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer


def _norm_spec(spec) -> Dict[str, Any]:
    if isinstance(spec, Mapping):
        return dict(spec)
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        kind, params = spec
        if not isinstance(kind, str):
            kind = getattr(kind, "__name__", str(kind))
        out = {"type": kind.replace("max_pooling2d", "max_pool")
               .replace("average_pooling2d", "avg_pool")}
        out.update(params)
        return out
    raise ValueError("Bad cnn layer spec: {!r}".format(spec))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_size(n: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-n // s)
    return (n - k) // s + 1


class CNNNet(nn.Module):
    """(B, H, W, C) in, (B, features) out."""

    def __init__(self, in_shape: Sequence[int], layers, dtype: torch.dtype,
                 dropout_bits: int, generator: torch.Generator):
        super().__init__()
        self.dtype, self.dropout_bits = dtype, dropout_bits
        init = resolve_initializer(None)
        shape = tuple(in_shape)               # per example, channels last
        self.plan = []
        for idx, raw in enumerate(layers, start=1):
            spec = _norm_spec(raw)
            kind = spec["type"]
            name = "{}_{}".format(kind, idx)
            step = {"kind": kind, "name": name,
                    "act": None if spec.get("activation") is None
                    else resolve_activation(spec["activation"])}
            if kind in ("conv2d", "conv"):
                k, s = _pair(spec["kernel_size"]), \
                    _pair(spec.get("strides", (1, 1)))
                pad = spec.get("padding", "SAME").upper()
                self.add_module(name, SameConv2d(
                    shape[-1], spec["filters"], k, s, dtype, init, generator,
                    padding=pad))
                shape = (_out_size(shape[0], k[0], s[0], pad),
                         _out_size(shape[1], k[1], s[1], pad),
                         spec["filters"])
            elif kind in ("max_pool", "avg_pool"):
                k = _pair(spec.get("pool_size", 2))
                s = _pair(spec.get("strides", k))
                pad = spec.get("padding", "VALID").upper()
                step.update(kernel=k, stride=s, padding=pad)
                shape = (_out_size(shape[0], k[0], s[0], pad),
                         _out_size(shape[1], k[1], s[1], pad), shape[2])
            elif kind in ("dense", "fc"):
                width = 1
                for n in shape:
                    width *= n
                self.add_module(name, Dense(width, spec["units"], dtype,
                                            init, generator))
                shape = (spec["units"],)
            elif kind == "flatten":
                width = 1
                for n in shape:
                    width *= n
                shape = (width,)
            elif kind == "dropout":
                step["keep"] = 1.0 - spec.get("rate", 0.5)
            elif kind in ("batch_norm", "bn"):
                # flax momentum is the running average's decay
                self.add_module(name, BatchNorm(
                    shape[-1], 1.0 - spec.get("momentum", 0.9),
                    spec.get("epsilon", 1e-4), dtype))
            else:
                raise ValueError("Unknown cnn layer type '{}'".format(kind))
            self.plan.append(step)
        width = 1
        for n in shape:
            width *= n
        self.out_features = width

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for step in self.plan:
            kind = step["kind"]
            if kind in ("conv2d", "conv"):
                x = self._modules[step["name"]](x)
            elif kind == "max_pool":
                x = max_pool(x, step["kernel"], step["stride"],
                             step["padding"])
            elif kind == "avg_pool":
                x = avg_pool(x, step["kernel"], step["stride"],
                             step["padding"])
            elif kind in ("dense", "fc"):
                x = self._modules[step["name"]](x.reshape(x.shape[0], -1))
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "dropout":
                if train:
                    x = dropout(x, step["keep"], generator,
                                self.dropout_bits)
            else:
                x = self._modules[step["name"]](x, train)
            if step["act"] is not None:
                x = step["act"](x)
        return x.reshape(x.shape[0], -1)


class CNNEncoderModule(nn.Module):

    def __init__(self, net: CNNNet):
        super().__init__()
        self.net = net
        self.out_shape = (net.out_features,)

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        return {"outputs": self.net(input_dict["source_tensors"][0], train,
                                    generator)}


class CNNEncoder(Encoder):
    """Config wrapper, same schema as the JAX package's
    (``data_format`` accepted with no effect: channels last always)."""

    takes_image_shape = True

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "cnn_layers": list,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "data_format": ["channels_first", "channels_last"],
            "fc_layers": list,
        })

    def make_module(self, in_shape: Sequence[int],
                    generator: torch.Generator) -> CNNEncoderModule:
        """``in_shape`` is an image's (H, W, C)."""
        p = self._params
        return CNNEncoderModule(CNNNet(
            in_shape, list(p["cnn_layers"]) + list(p.get("fc_layers", [])),
            self.compute_dtype,
            32 if self._model is None
            else self._model.params.get("dropout_bits", 32), generator))
