"""ResNet v1/v2 encoder (port of
``openseq2seq_tpu/encoders/resnet_encoder.py``).

Basic and bottleneck residual blocks, version 1 (conv, batch norm, relu;
relu after the residual add) and version 2 (batch norm and relu before
each conv), the first conv and max pool, and a global average pool.
Module and parameter names follow the flax module's (``init_conv``,
``init_bn``, ``block{i}_{j}`` with ``preact_bn``, ``proj``, ``proj_bn``,
``conv1`` to ``conv3``, ``bn1`` to ``bn3``; ``final_bn``) so that
``convert.py`` maps one onto the other.

Kept from the JAX package, each a trap when porting:
  * the activations stay (B, H, W, C), channels last, from the input to
    the pool: each conv runs over a channels-last (B, C, H, W) view
    (``ds2_encoder.SameConv2d``, no bias), so cuDNN takes its NHWC
    kernels;
  * SAME padding is XLA's, low = total // 2: asymmetric under a stride
    (the 7x7 stride-2 conv on 224 pads (2, 3), a 3x3 stride-2 conv on 56
    pads (0, 1), a 1x1 stride-2 projection (0, 0)), which torch's
    symmetric ``padding=`` would place one pixel off;
  * the SAME max pool pads with -inf on the same offsets ((0, 1) for 3x3
    stride 2 on 112), then pools unpadded (``max_pool``);
  * batch norm is flax's at momentum 0.997 (torch's 0.003) and eps 1e-5:
    biased running variance, statistics and normalization in fp32, output
    in the compute type (``tdnn_encoder.BatchNorm``);
  * the global average pool sums in fp32 and rounds once to the compute
    type, as ``jnp.mean`` of bf16 does.

The JAX module's ``checkpoint_name(x, "block_boundary")`` is a remat
anchor and a no-op without remat; it has no counterpart (the model key
``remat`` has no effect in the port).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ds2_encoder import SameConv2d
from .encoder import Encoder
from .tdnn_encoder import BatchNorm, same_padding
from ..parts.initializers import resolve_initializer

_RESNET_SIZES = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
    200: ([3, 24, 36, 3], True),
}


def pool_same(x: torch.Tensor, kernel: Tuple[int, int],
              stride: Tuple[int, int], pad_value: float) -> torch.Tensor:
    """(B, H, W, C) padded with ``pad_value`` on XLA's SAME offsets."""
    h_lo, h_hi = same_padding(x.shape[1], kernel[0], stride[0], 1)
    w_lo, w_hi = same_padding(x.shape[2], kernel[1], stride[1], 1)
    return F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=pad_value)


def max_pool(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], padding: str = "SAME") -> torch.Tensor:
    """flax ``nn.max_pool`` over (B, H, W, C): SAME pads with -inf on XLA's
    offsets, VALID pads nothing."""
    if padding == "SAME":
        x = pool_same(x, kernel, stride, float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel,
                        stride).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.avg_pool`` over (B, H, W, C), padded windows counted
    whole (its ``count_include_pad``): SAME pads zeros on XLA's offsets."""
    if padding == "SAME":
        x = pool_same(x, kernel, stride, 0.0)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), kernel,
                        stride).permute(0, 2, 3, 1)


class _Block(nn.Module):

    def __init__(self, in_ch: int, filters: int, stride: int,
                 bottleneck: bool, projection: bool, version: int,
                 bn_momentum: float, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        init = resolve_initializer(None)
        out_ch = filters * (4 if bottleneck else 1)
        self.version, self.bottleneck = version, bottleneck
        self.projection = projection
        self.out_ch = out_ch

        def conv(name, cin, cout, k, s):
            self.add_module(name, SameConv2d(cin, cout, (k, k), (s, s),
                                             dtype, init, generator,
                                             use_bias=False))

        def bn(name, ch):
            # flax momentum is the running average's decay
            self.add_module(name, BatchNorm(ch, 1.0 - bn_momentum, 1e-5,
                                            dtype))

        if version == 2:
            bn("preact_bn", in_ch)
        if projection:
            conv("proj", in_ch, out_ch, 1, stride)
            if version == 1:
                bn("proj_bn", out_ch)
        if bottleneck:
            # v2 strides the 3x3 conv, v1 the first 1x1
            conv("conv1", in_ch, filters, 1, 1 if version == 2 else stride)
            bn("bn1", filters)
            conv("conv2", filters, filters, 3, stride if version == 2 else 1)
            bn("bn2", filters)
            conv("conv3", filters, out_ch, 1, 1)
            if version == 1:
                bn("bn3", out_ch)
        else:
            conv("conv1", in_ch, filters, 3, stride)
            bn("bn1", filters)
            conv("conv2", filters, out_ch, 3, 1)
            if version == 1:
                bn("bn2", out_ch)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self._v2(x, train) if self.version == 2 else \
            self._v1(x, train)

    def _v2(self, x, train):
        preact = torch.relu(self.preact_bn(x, train))
        shortcut = self.proj(preact) if self.projection else x
        y = torch.relu(self.bn1(self.conv1(preact), train))
        y = self.conv2(y)
        if self.bottleneck:
            y = self.conv3(torch.relu(self.bn2(y, train)))
        return shortcut + y

    def _v1(self, x, train):
        shortcut = self.proj_bn(self.proj(x), train) if self.projection \
            else x
        y = torch.relu(self.bn1(self.conv1(x), train))
        if self.bottleneck:
            y = torch.relu(self.bn2(self.conv2(y), train))
            y = self.bn3(self.conv3(y), train)
        else:
            y = self.bn2(self.conv2(y), train)
        return torch.relu(shortcut + y)


class ResNetNet(nn.Module):
    """(B, H, W, C) images in, (B, C') pooled features out."""

    def __init__(self, in_shape: Sequence[int], block_sizes: Sequence[int],
                 block_strides: Sequence[int], version: int,
                 bottleneck: bool, first_num_filters: int,
                 first_kernel_size: int, first_conv_stride: int,
                 first_pool_size: int, first_pool_stride: int,
                 bn_momentum: float, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.version, self.dtype = version, dtype
        k = first_kernel_size
        self.init_conv = SameConv2d(
            in_shape[-1], first_num_filters, (k, k), (first_conv_stride,) * 2,
            dtype, resolve_initializer(None), generator, use_bias=False)
        if version == 1:
            self.init_bn = BatchNorm(first_num_filters, 1.0 - bn_momentum,
                                     1e-5, dtype)
        self.pool = (first_pool_size, first_pool_stride)
        ch = first_num_filters
        self.blocks = []
        for i, (n_blocks, stride) in enumerate(zip(block_sizes,
                                                   block_strides)):
            for j in range(n_blocks):
                name = "block{}_{}".format(i + 1, j + 1)
                block = _Block(ch, first_num_filters * 2 ** i,
                               stride if j == 0 else 1, bottleneck, j == 0,
                               version, bn_momentum, dtype, generator)
                self.add_module(name, block)
                self.blocks.append(name)
                ch = block.out_ch
        if version == 2:
            self.final_bn = BatchNorm(ch, 1.0 - bn_momentum, 1e-5, dtype)
        self.out_features = ch

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.init_conv(x.to(self.dtype))
        if self.version == 1:
            x = torch.relu(self.init_bn(x, train))
        size, stride = self.pool
        if size:
            x = max_pool(x, (size, size), (stride, stride))
        for name in self.blocks:
            x = self._modules[name](x, train)
        if self.version == 2:
            x = torch.relu(self.final_bn(x, train))
        # global average pool: fp32 sums, one rounding
        return x.float().mean((1, 2)).to(self.dtype)


class ResNetEncoderModule(nn.Module):

    def __init__(self, net: ResNetNet):
        super().__init__()
        self.net = net
        self.out_shape = (net.out_features,)

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` is unused: the network has no dropout."""
        return {"outputs": self.net(input_dict["source_tensors"][0], train)}


class ResNetEncoder(Encoder):
    """Config wrapper, same schema as the JAX package's; ``data_format``,
    ``regularize_bn`` and ``bn_epsilon`` are accepted and, as there, have
    no effect (NHWC always, eps 1e-5)."""

    takes_image_shape = True

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "resnet_size": int,
            "block_sizes": list,
            "block_strides": list,
            "version": [1, 2],
            "bottleneck": bool,
            "final_size": int,
            "first_num_filters": int,
            "first_kernel_size": int,
            "first_conv_stride": int,
            "first_pool_size": int,
            "first_pool_stride": int,
            "data_format": ["channels_first", "channels_last"],
            "regularize_bn": bool,
            "bn_momentum": float,
            "bn_epsilon": float,
        })

    def make_module(self, in_shape: Sequence[int],
                    generator: torch.Generator) -> ResNetEncoderModule:
        """``in_shape`` is an image's (H, W, C)."""
        p = self._params
        sizes, bottleneck = _RESNET_SIZES.get(p.get("resnet_size", 50),
                                              ([3, 4, 6, 3], True))
        return ResNetEncoderModule(ResNetNet(
            in_shape=in_shape,
            block_sizes=p.get("block_sizes", sizes),
            block_strides=p.get("block_strides", [1, 2, 2, 2]),
            version=p.get("version", 2),
            bottleneck=p.get("bottleneck", bottleneck),
            first_num_filters=p.get("first_num_filters", 64),
            first_kernel_size=p.get("first_kernel_size", 7),
            first_conv_stride=p.get("first_conv_stride", 2),
            first_pool_size=p.get("first_pool_size", 3),
            first_pool_stride=p.get("first_pool_stride", 2),
            bn_momentum=p.get("bn_momentum", 0.997),
            dtype=self.compute_dtype, generator=generator))
