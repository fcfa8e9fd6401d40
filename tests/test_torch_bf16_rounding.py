"""C26: the port's bf16 dense and biased conv layers round as flax does.

flax's ``nn.Dense`` and ``nn.Conv`` under a bf16 compute dtype round the
product (or the conv) to bf16, then add the bias and round again. A bias
fused into the product's epilogue (``F.linear(x, w, b)``,
``F.conv2d(x, w, b)``) rounds once. The port's ``Dense`` (both:
``parts/transformer/common.py`` and ``decoders/fc_decoders.py``),
``SameConv2d`` and ``SameConv1d`` take the two-rounding form; the
one-rounding form stays here as a planted fault.

Each case holds both forms against flax on the same fp32 weights and
inputs, made from numpy seeds, and reads two numbers over the bf16
outputs: the share that differ from flax's, and the largest difference in
bf16 ulps (of flax's value). The repaired form may differ only where the
product's own summation order moves a rounding: at most 2% of the
outputs and 1 ulp. The one-rounding form must differ in more than 10%
(about a quarter was seen on Transformer-XL)."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openseq2seq_tpu_torch.decoders.fc_decoders import Dense as FCDense
from openseq2seq_tpu_torch.encoders.ds2_encoder import SameConv2d
from openseq2seq_tpu_torch.encoders.tdnn_encoder import (SameConv1d,
                                                       same_padding)
from openseq2seq_tpu_torch.parts.initializers import resolve_initializer
from openseq2seq_tpu_torch.parts.transformer.common import Dense
from test_torch_text_data import one_thread  # noqa: F401

REPAIRED_SHARE, REPAIRED_ULPS = 0.02, 1.0
FAULT_SHARE = 0.10


def readings(got: torch.Tensor, want) -> tuple:
    """(share of outputs that differ, largest difference in bf16 ulps: the
    spacing of bf16 at the larger of the two values, or at a thousandth of
    the output's largest magnitude where both are smaller, so that a sum
    that cancels to about 0 does not read as millions of ulps)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    mag = np.maximum(np.maximum(np.abs(w), np.abs(g)),
                     1e-3 * np.abs(w).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    diff = np.abs(g - w) / ulp
    return float(np.mean(g != w)), float(diff.max())


def _check(name, repaired, fault):
    share, ulps = repaired
    f_share, f_ulps = fault
    print("[c26] {}: repaired {:.4f} of outputs differ, at most {:.1f} "
          "ulp; one rounding {:.4f}, {:.1f} ulp".format(
              name, share, ulps, f_share, f_ulps))
    assert share <= REPAIRED_SHARE and ulps <= REPAIRED_ULPS, repaired
    assert f_share > FAULT_SHARE, fault


@pytest.mark.parametrize("B,din,dout,seed", [(8, 64, 96, 0), (16, 128, 32, 1),
                                             (4, 256, 128, 2)])
@pytest.mark.parametrize("cls", ["common", "fc"])
def test_dense_rounds_as_flax(B, din, dout, seed, cls):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, din).astype(np.float32)
    w = (rng.randn(din, dout) / np.sqrt(din)).astype(np.float32)
    b = rng.randn(dout).astype(np.float32)
    want = nn.Dense(dout, dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    gen = torch.Generator().manual_seed(0)
    layer = Dense(din, dout, torch.bfloat16, gen) if cls == "common" else \
        FCDense(din, dout, torch.bfloat16, resolve_initializer(None), gen)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x))
        fault = F.linear(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w.T).bfloat16(),
                         torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    _check("Dense ({}) {}x{}->{}".format(cls, B, din, dout),
           readings(got, want), readings(fault, want))


@pytest.mark.parametrize("shape,kernel,stride,seed", [
    ((4, 12, 10, 8), (3, 3), (1, 1), 3), ((2, 15, 9, 16), (3, 5), (2, 2), 4),
    ((4, 8, 8, 4), (5, 5), (2, 1), 5)])
def test_conv2d_rounds_as_flax(shape, kernel, stride, seed):
    rng = np.random.RandomState(seed)
    cin, cout = shape[-1], 24
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(*kernel, cin, cout) /
         np.sqrt(cin * np.prod(kernel))).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = nn.Conv(cout, kernel, strides=stride, padding="SAME",
                   dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    layer = SameConv2d(cin, cout, kernel, stride, torch.bfloat16,
                       resolve_initializer(None), torch.Generator())
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x))
        # the planted fault: the same padded conv with the bias fused
        fault = F.conv2d(*_same_pad2d(x, kernel, stride),
                         layer.weight.bfloat16(),
                         torch.from_numpy(b).bfloat16(), stride)
        fault = fault.permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _check("SameConv2d {} k{} s{}".format(shape, kernel, stride),
           readings(got, want), readings(fault, want))


def _same_pad2d(x, kernel, stride):
    t = torch.from_numpy(x).bfloat16()
    t_lo, t_hi = same_padding(x.shape[1], kernel[0], stride[0], 1)
    f_lo, f_hi = same_padding(x.shape[2], kernel[1], stride[1], 1)
    return (F.pad(t, (0, 0, f_lo, f_hi, t_lo, t_hi)).permute(0, 3, 1, 2),)


@pytest.mark.parametrize("B,T,cin,cout,k,stride,dil,seed", [
    (4, 37, 16, 32, 11, 2, 1, 6), (2, 40, 32, 16, 3, 1, 2, 7),
    (8, 20, 8, 64, 1, 1, 1, 8)])
def test_conv1d_rounds_as_flax(B, T, cin, cout, k, stride, dil, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, cin).astype(np.float32)
    kern = (rng.randn(k, cin, cout) / np.sqrt(cin * k)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = nn.Conv(cout, (k,), strides=(stride,), kernel_dilation=(dil,),
                   padding="SAME", dtype=jnp.bfloat16,
                   param_dtype=jnp.float32).apply(
        {"params": {"kernel": kern, "bias": b}}, jnp.asarray(x))
    layer = SameConv1d(cin, cout, k, stride, dil, torch.bfloat16,
                       resolve_initializer(None), torch.Generator())
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kern.transpose(2, 1, 0)))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x))
        lo, hi = same_padding(T, k, stride, dil)
        xp = F.pad(torch.from_numpy(x).bfloat16(), (0, 0, lo, hi))
        fault = F.conv1d(xp.permute(0, 2, 1), layer.weight.bfloat16(),
                         torch.from_numpy(b).bfloat16(), stride, 0,
                         dil).permute(0, 2, 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _check("SameConv1d B{} T{} {}->{} k{} s{} d{}".format(
        B, T, cin, cout, k, stride, dil),
        readings(got, want), readings(fault, want))


def test_fp32_keeps_the_fused_form():
    """In fp32 the layers keep the bias in the product (one launch): the
    two forms differ only by fp32 rounding."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(6, 32).astype(np.float32))
    layer = Dense(32, 16, torch.float32, torch.Generator().manual_seed(1))
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(rng.randn(16).astype(np.float32)))
        got = layer(x)
        assert torch.equal(got, F.linear(x, layer.weight, layer.bias))
        torch.testing.assert_close(got, F.linear(x, layer.weight) +
                                   layer.bias, rtol=1e-6, atol=1e-6)


def test_readings_see_a_bias_left_out():
    """The readings refuse a layer whose bias was left out entirely."""
    want = jnp.asarray(np.linspace(-3, 3, 50), jnp.bfloat16)
    got = torch.from_numpy(np.asarray(want, np.float32) - 0.5).bfloat16()
    share, ulps = readings(got, want)
    assert share > 0.9 and ulps > 1.0
