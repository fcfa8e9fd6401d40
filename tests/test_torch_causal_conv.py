"""The port's causal convolution against the JAX package's:

  * ``CausalConv1d`` against flax's ``padding="CAUSAL"`` conv at
    dilations 1, 2 and 8 (and stride 2), outputs and gradients; a planted
    symmetric pad, the SAME conv on the same weights, is refused at every
    dilation;
  * ``TemporalConvolutionalLayer`` against the JAX layer;
  * the TDNN encoder's ``tcn`` blocks against the JAX encoder's.

Tolerance: fp32 rtol 1e-5, atol 1e-5 on outputs; a gradient within 1e-5
of its leaf's largest magnitude plus rtol 1e-5.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu import encoders as jax_encoders
from openseq2seq_tpu.parts.rnns import rnn as jax_rnn
from openseq2seq_tpu_torch import encoders
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders.tdnn_encoder import (CausalConv1d,
                                                         SameConv1d)
from openseq2seq_tpu_torch.parts.initializers import resolve_initializer
from openseq2seq_tpu_torch.parts.rnns import rnn
from test_torch_centaur import _perturbed_weights
from test_torch_convs2s import assert_grads_close
# torch on one thread
from test_torch_text_data import one_thread  # noqa: F401


def _conv_case(k, d, stride, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 23, 5).astype(np.float32)
    w = rng.randn(k, 5, 7).astype(np.float32) * 0.3
    b = rng.randn(7).astype(np.float32)
    return x, w, b


def _torch_conv(cls, w, b, d, stride):
    conv = cls(w.shape[1], w.shape[2], w.shape[0], stride, d, torch.float32,
               resolve_initializer(None), torch.Generator())
    conv.load_state_dict(state_dict_from_flax(
        {"params": {"kernel": w, "bias": b}}))
    return conv


@pytest.mark.parametrize("d,stride", [(1, 1), (2, 1), (8, 1), (2, 2)])
def test_causal_conv_matches_flax(d, stride):
    """Outputs and the gradients of a weighted sum, against flax's CAUSAL
    conv; the SAME conv on the same weights (a symmetric pad) reads far
    off, so the comparison would catch it."""
    x, w, b = _conv_case(3, d, stride, d + stride)
    conv = fnn.Conv(7, (3,), strides=(stride,), kernel_dilation=(d,),
                    padding="CAUSAL")
    weights = np.random.RandomState(9).randn(
        2, -(-23 // stride), 7).astype(np.float32)

    def objective(p, x):
        y = conv.apply({"params": p}, x)
        return jnp.sum(y * weights), y
    (_, want), (gp, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(
            {"kernel": w, "bias": b}, x)
    mine = _torch_conv(CausalConv1d, w, b, d, stride)
    xt = torch.from_numpy(x).requires_grad_()
    got = mine(xt)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-5, atol=1e-5)
    assert_grads_close(flax_from_state_dict(
        {n: p.grad for n, p in mine.named_parameters()})["params"],
        jax.device_get(gp))
    with torch.no_grad():
        planted = _torch_conv(SameConv1d, w, b, d, stride)(xt)
    assert np.abs(planted.numpy() - np.asarray(want)).max() > 0.1


def test_temporal_convolutional_layer_matches_jax():
    """The JAX package's ``TemporalConvolutionalLayer`` (stride 1,
    dilation 4, no bias) and the port's on the same weights."""
    x = np.random.RandomState(3).randn(2, 19, 5).astype(np.float32)
    jtcn = jax_rnn.TemporalConvolutionalLayer(filters=6, kernel_size=3,
                                              dilation=4, use_bias=False)
    variables = jtcn.init(jax.random.PRNGKey(0), x)
    want = jtcn.apply(variables, x)
    tcn = rnn.TemporalConvolutionalLayer(5, 6, 3, dilation=4,
                                         use_bias=False)
    tcn.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = tcn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tdnn_tcn_matches_jax():
    """A TDNN encoder of ``tcn`` blocks (a dilated, residual one, then two
    strided ones) in eval against the JAX encoder, the lengths too."""
    layers = [{"type": "tcn", "repeat": 1, "kernel_size": [3],
               "stride": [1], "num_channels": 12, "padding": "SAME",
               "dilation": [2], "dropout_keep_prob": 1.0,
               "residual": True},
              {"type": "tcn", "repeat": 2, "kernel_size": [5],
               "stride": [2], "num_channels": 12, "padding": "SAME",
               "dilation": [1], "dropout_keep_prob": 1.0},
              {"type": "conv1d", "repeat": 1, "kernel_size": [1],
               "stride": [1], "num_channels": 8, "padding": "SAME",
               "dilation": [1], "dropout_keep_prob": 1.0}]
    params = {"convnet_layers": layers, "dropout_keep_prob": 1.0,
              "activation_fn": "relu", "normalization": "batch_norm",
              "use_conv_mask": True}
    x = np.random.RandomState(4).randn(3, 21, 7).astype(np.float32)
    lengths = np.array([21, 13, 6], np.int32)
    jmod = jax_encoders.TDNNEncoder(dict(params, activation_fn=jax.nn.relu),
                                    None, mode="eval").make_module()
    mod = encoders.TDNNEncoder(params, None, mode="eval").make_module(
        7, torch.Generator().manual_seed(0))
    assert isinstance(mod.net.conv2_1, CausalConv1d)
    assert isinstance(mod.net.res1_0, SameConv1d)
    variables = _perturbed_weights(mod, 5)
    jin = {"source_tensors": [x, lengths]}
    want = jmod.apply(variables, jin, train=False)
    with torch.no_grad():
        got = mod({"source_tensors": [torch.from_numpy(x),
                                      torch.from_numpy(lengths)]}, False)
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  want["src_length"])
    np.testing.assert_allclose(got["outputs"].numpy(), want["outputs"],
                               rtol=1e-5, atol=1e-5)
