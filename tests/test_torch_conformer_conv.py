"""The port's fused Conformer conv module (``ops/conformer_conv.py``,
kernel B6's plain version) against the JAX package's
``ops/conformer_pallas.py`` kernel in interpret mode, forward and (under
autograd, against ``jax.vjp``) backward, and the port's
``_ConvModule`` on both of its paths against the JAX module's, with
weights carried by ``convert.py``; and what ``supported`` refuses.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 rtol and atol 1e-5 (sums in another order). bf16: both
sides round the same operands and the output once, so they differ only
where fp32 sums taken in another order fall on either side of a bf16
rounding: at most one bf16 ulp, 2^-8 of max(1, |value|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from openseq2seq_tpu.encoders import conformer_encoder as jce
from openseq2seq_tpu.ops import conformer_pallas as jcp
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.encoders.conformer_encoder import _ConvModule
from openseq2seq_tpu_torch.ops import conformer_conv as cc
from test_torch_text_data import one_thread  # noqa: F401

B, D = 3, 128
NAMES = ("ln1_scale", "ln1_bias", "pw1_kernel", "pw1_bias", "dw_kernel",
         "dw_bias", "ln2_scale", "ln2_bias", "pw2_kernel", "pw2_bias")


def _case(T, k, seed):
    """x (B, T, D), lengths T, T - 13 and 5, and the ten weights with
    random norms and biases."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([T, max(T - 13, 0), 5], np.int32)
    shapes = {"pw1_kernel": (D, 2 * D), "pw1_bias": (2 * D,),
              "dw_kernel": (k, D), "pw2_kernel": (D, D)}
    fans = {"pw1_kernel": D, "dw_kernel": k, "pw2_kernel": D}
    weights = {}
    for name in NAMES:
        shape = shapes.get(name, (D,))
        if name in fans:
            w = rng.randn(*shape) / np.sqrt(fans[name])
        elif name.endswith("scale"):
            w = rng.uniform(0.5, 1.5, shape)
        else:
            w = 0.1 * rng.randn(*shape)
        weights[name] = w.astype(np.float32)
    return x, lengths, weights


@pytest.mark.parametrize("T,k", [(13, 7), (50, 31), (13, 31)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_pallas_kernel(dtype, T, k):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, lengths, w = _case(T, k, seed=T + k)
    want = jcp.conformer_conv_module(
        jnp.asarray(x, jdt), jnp.asarray(lengths),
        *(jnp.asarray(w[n]) for n in NAMES), interpret=True)
    got = cc.conformer_conv_module_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(lengths),
        *(torch.from_numpy(w[n]) for n in NAMES))
    assert got.dtype == tdt and got.shape == (B, T, D)
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got.float().numpy() - want) <=
                      2.0 ** -8 * np.maximum(1.0, np.abs(want)))
    # the entry takes the plain version for CPU tensors
    again = cc.conformer_conv_module(
        torch.from_numpy(x).to(tdt), torch.from_numpy(lengths),
        *(torch.from_numpy(w[n]) for n in NAMES))
    assert torch.equal(again, got)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_module_matches_jax(fused, monkeypatch):
    """``_ConvModule`` in fp32 on the JAX module's weights: the unfused
    chain against the XLA path, the fused one (B6's plain version)
    against the Pallas kernel in interpret mode."""
    T, k = 29, 7
    x, lengths, w = _case(T, k, seed=5)
    jmod = jce._ConvModule(kernel_size=k, dropout=0.0, norm="layer_norm",
                           dtype=jnp.float32, fused=fused)
    monkeypatch.setattr(jcp, "FORCE_INTERPRET", fused)
    want = jmod.apply({"params": w}, x, lengths, False)
    port = nn.ModuleDict({"conv": _ConvModule(
        D, k, torch.float32, fused, torch.Generator().manual_seed(0))})
    port.load_state_dict(state_dict_from_flax({"params": {"conv": w}}))
    with torch.no_grad():
        got = port["conv"](torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_backward_matches_jax_vjp(dtype):
    """``conformer_conv_module`` under autograd on CPU tensors (the plain
    forward and backward) against ``jax.vjp`` of the JAX op with its Pallas
    kernels in interpret mode: dx and the ten weight gradients, lengths T,
    T - 13 and 0. Each gradient within 1e-5 of its largest magnitude in
    fp32 (sums in another order); in bf16 within 2^-8 of it: both sides
    round the same product operands, from fp32 values summed in another
    order, so an operand may round the other way."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    T, k = 21, 7
    x, lengths, w = _case(T, k, seed=11)
    lengths[2] = 0
    dy = np.random.RandomState(12).randn(B, T, D).astype(np.float32)
    _, vjp = jax.vjp(
        lambda xx, *ws: jcp.conformer_conv_module(
            xx, jnp.asarray(lengths), *ws, interpret=True),
        jnp.asarray(x, jdt), *(jnp.asarray(w[n]) for n in NAMES))
    want = vjp(jnp.asarray(dy, jdt))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_()] + \
        [torch.from_numpy(w[n]).requires_grad_() for n in NAMES]
    y = cc.conformer_conv_module(leaves[0], torch.from_numpy(lengths),
                                 *leaves[1:])
    y.backward(torch.from_numpy(dy).to(tdt))
    tol = 1e-5 if dtype == "fp32" else 2.0 ** -8
    for name, leaf, g in zip(("x",) + NAMES, leaves, want):
        g = np.asarray(g, np.float32)
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == g.shape
        err = np.abs(leaf.grad.float().numpy() - g).max()
        assert err <= tol * np.abs(g).max(), (name, err)


def test_supported_and_refusals():
    assert cc.supported("layer_norm") and not cc.supported("batch_norm")
    assert cc.kernel_supports(256, 31) and cc.kernel_supports(512, 31)
    assert cc.kernel_supports(128, 7)
    assert not cc.kernel_supports(96, 31) and not cc.kernel_supports(1024, 31)
    assert not cc.kernel_supports(256, 65)
    params = {"num_layers": 1, "hidden_size": 128, "num_heads": 4,
              "conv_norm": "batch_norm"}
    for mode in ("eval", "train"):
        with pytest.raises(NotImplementedError, match="batch_norm"):
            ConformerEncoder(params, None, mode=mode)
    # training is ported: the layer-norm variant builds in train mode
    ConformerEncoder(dict(params, conv_norm="layer_norm"), None,
                     mode="train")
    x, lengths, w = _case(13, 7, seed=0)
    args = (torch.from_numpy(x), torch.from_numpy(lengths)) + \
        tuple(torch.from_numpy(w[n]) for n in NAMES)
    before = cc.LAUNCHES, cc.BWD_LAUNCHES
    with pytest.raises(ValueError, match="device cpu"):
        cc.conformer_conv_module_cuda(*args)
    with pytest.raises(ValueError, match="device cpu"):
        cc.conformer_conv_module_cuda_bwd(*args, args[0])
    assert (cc.LAUNCHES, cc.BWD_LAUNCHES) == before
