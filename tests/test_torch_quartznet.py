"""The port's separable TDNN blocks and the TDNN's other normalizations
against the JAX package's, and QuartzNet's tiny twin in training.

  * ``sep_conv1d`` (a depthwise conv, one group a channel, with the
    block's stride and dilation, then a 1x1 pointwise conv) under each
    normalization, ``batch_norm`` (randomized statistics), ``layer_norm``,
    ``instance_norm`` and None, residual projections included: the
    outputs and the gradient of every parameter and of the input, fp32,
    rtol 1e-5 and atol 1e-5 (the gradients atol 2e-5 over sums of up to
    a few hundred terms); the converted tree round-trips leaf for leaf;
  * the same blocks under bf16 ("mixed"): batch norm, layer norm and None
    give flax's bf16 outputs bit for bit (the depthwise and pointwise
    convs' biases added after the product is rounded, C26); instance
    norm, whose bf16 roundings compound through the stack (and whose JAX
    ops XLA fuses), within twice the JAX package's own bf16 error (its
    bf16 outputs against its fp32 ones on the same weights) of both;
  * C26 held on the depthwise conv alone against flax's grouped
    ``nn.Conv`` (``test_torch_bf16_rounding``'s readings);
  * what the port still refuses, as the JAX module would compute it
    wrongly or not at all: ``padding: VALID`` (the lengths are mapped as
    SAME maps them) and an unknown block type;
  * QuartzNet cut to a few separable blocks, fp32, NovoGrad and cosine
    decay with its CTC loss's ``use_pallas`` (the kernels' plain versions
    here, the JAX package's XLA scan): three train steps' losses, the
    parameters and statistics after them, rtol 1e-4, atol 1e-6."""
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer as \
    JaxSyntheticSpeech
from openseq2seq_tpu.decoders import FullyConnectedCTCDecoder as JaxCTCDec
from openseq2seq_tpu.encoders import TDNNEncoder as JaxTDNNEncoder
from openseq2seq_tpu.losses import CTCLoss as JaxCTCLoss
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.encoders.tdnn_encoder import SameConv1d
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.parts.initializers import resolve_initializer
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_bf16_rounding import _check, readings
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

RTOL = ATOL = 1e-5
GRAD_ATOL = 2e-5
FEATURES = 12
NORMS = ["batch_norm", "layer_norm", "instance_norm", None]


def _sep(k, ch, repeat=1, stride=1, dilation=1, residual=False):
    return {"type": "sep_conv1d", "repeat": repeat, "kernel_size": [k],
            "stride": [stride], "num_channels": ch, "padding": "SAME",
            "dilation": [dilation],
            **({"residual": True, "residual_dense": False}
               if residual else {})}


def _layers():
    return [_sep(5, 16, stride=2), _sep(7, 24, repeat=2, residual=True),
            _sep(9, 24, dilation=2),
            {"type": "conv1d", "repeat": 1, "kernel_size": [1],
             "stride": [1], "num_channels": 32, "padding": "SAME",
             "dilation": [1]}]


def _params(norm, dtype):
    return {"convnet_layers": _layers(), "dropout_keep_prob": 1.0,
            "normalization": norm, "activation_fn": "relu",
            "use_conv_mask": True, "dtype": dtype,
            "initializer": "xavier"}


def _pair(norm, dtype, seed):
    """(port module, JAX module, randomized variables, x, lengths)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 21, FEATURES).astype(np.float32)
    lengths = np.array([21, 15, 9], np.int32)
    jmod = JaxTDNNEncoder(dict(_params(norm, dtype),
                               activation_fn=jax.nn.relu),
                          model=None, mode="eval").make_module()
    variables = randomize(jmod.init(jax.random.PRNGKey(seed),
                                    {"source_tensors": [x, lengths]},
                                    train=False), seed=seed)
    module = TDNNEncoder(_params(norm, dtype), model=None, mode="eval") \
        .make_module(FEATURES, torch.Generator().manual_seed(0))
    module.load_state_dict(state_dict_from_flax(variables))
    return module, jmod, variables, x, lengths


def _port_out(module, x, lengths, train=False):
    return module({"source_tensors": [torch.from_numpy(x),
                                      torch.from_numpy(lengths)]},
                  train=train)


@pytest.mark.parametrize("norm", NORMS)
def test_separable_tdnn_matches_jax_with_gradients(norm):
    module, jmod, variables, x, lengths = _pair(norm, "float32", 3)
    cot = np.random.RandomState(4).randn(3, 11, 32).astype(np.float32)

    def jloss(params, xx):
        out = jmod.apply(dict(variables, params=params),
                         {"source_tensors": [xx, lengths]}, train=False)
        return jnp.sum(out["outputs"] * cot), out
    (_, want), (jgrad, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = module({"source_tensors": [xt, torch.from_numpy(lengths)]},
                 train=False)
    (got["outputs"] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got["outputs"].detach().numpy(),
                               np.asarray(want["outputs"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  np.asarray(want["src_length"]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=GRAD_ATOL)
    # every parameter's gradient, leaf by leaf through the inverse
    # converter (the buffers only name the batch norms)
    named = dict(module.named_parameters())
    grads = {k: (named[k].grad if k in named else v)
             for k, v in module.state_dict().items()}
    ln = layer_norm_modules(module)
    got_grads = flax_from_state_dict(grads, ln)["params"]
    want_grads = jax.tree_util.tree_map(np.asarray, jgrad)
    assert jax.tree_util.tree_structure(got_grads) == \
        jax.tree_util.tree_structure(want_grads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_grads),
                            jax.tree_util.tree_leaves(want_grads)):
        where = jax.tree_util.keystr(path)
        if norm == "instance_norm" and "bias" in where:
            # the norm subtracts each channel's mean over time, so these
            # biases' gradients are 0 in exact arithmetic: rounding noise
            # on both sides, held near 0 rather than to each other
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4, where
            continue
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=GRAD_ATOL * max(1.0, np.abs(w).max()),
            err_msg=where)
    # the tree back, leaf for leaf
    back = flax_from_state_dict(module.state_dict(), ln)
    for name in ("params", "batch_stats"):
        if name in variables:
            jax.tree_util.tree_map(np.testing.assert_array_equal,
                                   back[name], variables[name])
    if norm == "layer_norm":
        assert "LayerNorm_0" in variables["params"]["net"]["norm1_1"]
    if norm in ("instance_norm", None):
        assert not any(k.startswith(("norm", "resnorm"))
                       for k in variables["params"]["net"])


@pytest.mark.parametrize("norm", NORMS)
def test_separable_tdnn_bf16_rounds_as_flax(norm):
    module, jmod, variables, x, lengths = _pair(norm, "bfloat16", 5)
    want = np.asarray(jmod.apply(variables, {"source_tensors": [x, lengths]},
                                 train=False)["outputs"], np.float32)
    with torch.no_grad():
        got = _port_out(module, x, lengths)["outputs"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if norm == "instance_norm":
        # through four instance norms over 11 frames the bf16 roundings
        # compound; held to the JAX package's own bf16 error, its bf16
        # output against its fp32 one on the same weights
        _, jmod32, _, _, _ = _pair(norm, "float32", 5)
        want32 = np.asarray(jmod32.apply(
            variables, {"source_tensors": [x, lengths]},
            train=False)["outputs"], np.float32)
        jax_err = np.abs(want - want32).max()
        assert np.abs(got - want).max() <= 2 * jax_err
        assert np.abs(got - want32).max() <= 2 * jax_err
    else:
        np.testing.assert_array_equal(got, want)


def test_depthwise_conv_rounds_as_flax():
    rng = np.random.RandomState(11)
    B, T, C, k = 4, 37, 32, 9
    x = rng.randn(B, T, C).astype(np.float32)
    kern = (rng.randn(k, 1, C) / np.sqrt(k)).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    want = fnn.Conv(C, (k,), strides=(2,), kernel_dilation=(1,),
                    padding="SAME", feature_group_count=C,
                    dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": kern, "bias": b}}, jnp.asarray(x))
    layer = SameConv1d(C, C, k, 2, 1, torch.bfloat16,
                       resolve_initializer(None), torch.Generator(),
                       groups=C)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kern.transpose(2, 1, 0)))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x))
        layer.dtype = torch.float32     # the fused form, rounded once
        fault = (layer(torch.from_numpy(x).bfloat16().float())
                 .bfloat16())
    assert got.shape == want.shape
    _check("depthwise SameConv1d B4 T37 C32 k9 s2", readings(got, want),
           readings(fault, want))


@pytest.mark.parametrize("spec", [
    dict(_sep(5, 16), padding="VALID"),
    {"type": "conv1d", "repeat": 1, "kernel_size": [3], "stride": [1],
     "num_channels": 8, "padding": "VALID"},
    {"type": "conv2d", "repeat": 1, "kernel_size": [3], "stride": [1],
     "num_channels": 8, "padding": "SAME"}])
def test_unported_block_options_raise(spec):
    params = dict(_params("batch_norm", "float32"), convnet_layers=[spec])
    with pytest.raises(NotImplementedError, match="SAME padding"):
        TDNNEncoder(params, model=None, mode="eval").make_module(
            FEATURES, torch.Generator())
    with pytest.raises(ValueError, match="normalization"):
        TDNNEncoder(dict(params, normalization="group_norm"), model=None,
                    mode="eval")


# QuartzNet's tiny twin ----------------------------------------------------
STEPS = 3
TINY_B, TINY_T, TINY_L, TINY_V = 4, 41, 6, 29
# the biases of the convs before a batch norm (depthwise and pointwise
# ones too): the norm removes them, so their gradient is rounding noise
# that NovoGrad would scale to a full update
FREEZE = r"/(conv|res)\d+_\d+(_dw|_pw)?/bias$"


def _quartznet(classes, data_layer):
    encoder, decoder, loss = classes
    return {
        "random_seed": 0, "batch_size_per_gpu": TINY_B, "max_steps": STEPS,
        "print_loss_steps": 1, "dtype": "float32",
        "freeze_variables_regex": FREEZE,
        "optimizer": "NovoGrad",
        "optimizer_params": {"beta1": 0.95, "beta2": 0.5, "epsilon": 1e-8,
                             "weight_decay": 0.001,
                             "grad_averaging": False},
        "lr_policy": "cosine_decay",
        "lr_policy_params": {"learning_rate": 0.01, "min_lr": 0.0,
                             "warmup_steps": 1, "decay_steps": 10},
        "encoder": encoder,
        "encoder_params": {
            "convnet_layers": [_sep(7, 16, stride=2),
                               _sep(9, 16, repeat=2, residual=True),
                               _sep(11, 24, dilation=2),
                               {"type": "conv1d", "repeat": 1,
                                "kernel_size": [1], "stride": [1],
                                "num_channels": 32, "padding": "SAME",
                                "dilation": [1]}],
            "dropout_keep_prob": 1.0, "initializer": "xavier",
            "normalization": "batch_norm",
            "activation_fn": "relu" if encoder is TDNNEncoder
            else jax.nn.relu,
            "use_conv_mask": True},
        "decoder": decoder,
        "decoder_params": {"initializer": "xavier",
                           "use_language_model": False},
        "loss": loss, "loss_params": {"use_pallas": True},
        "data_layer": data_layer,
        "data_layer_params": {"num_audio_features": FEATURES,
                              "tgt_vocab_size": TINY_V,
                              "time_steps": TINY_T,
                              "label_length": TINY_L, "num_batches": 1},
    }


def _batch():
    rng = np.random.RandomState(0)
    return {"source_tensors": [
        rng.randn(TINY_B, TINY_T, FEATURES).astype(np.float32),
        np.array([TINY_T, 37, 29, 23], np.int32)],
        "target_tensors": [
            rng.randint(0, TINY_V - 1, (TINY_B, TINY_L)).astype(np.int32),
            np.array([TINY_L, 5, 4, 6], np.int32)]}


def test_quartznet_tiny_train_steps_match_jax(jax_globals):  # noqa: F811
    from openseq2seq_tpu_torch.data.synthetic import \
        SyntheticSpeechDataLayer
    from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
    from openseq2seq_tpu_torch.losses import CTCLoss
    batch = _batch()
    jmodel = JaxSpeech2Text(_quartznet(
        (JaxTDNNEncoder, JaxCTCDec, JaxCTCLoss), JaxSyntheticSpeech),
        mode="train")
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=2)
    jstate = jstate.replace(
        params=variables["params"],
        model_state={"batch_stats": variables["batch_stats"]},
        opt_state=jmodel.optimizer().init(variables["params"]))
    step = jax.jit(jmodel.train_step)
    jlosses = []
    for i in range(STEPS):
        jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
        jlosses.append(float(metrics["loss"]))

    model = Speech2Text(_quartznet(
        (TDNNEncoder, FullyConnectedCTCDecoder, CTCLoss),
        SyntheticSpeechDataLayer), mode="train", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    assert any(re.search(FREEZE, "/" + "/".join(p))
               for p, _ in model._named_params(state.module))
    losses = []
    for _ in range(STEPS):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    assert losses[-1] < losses[0]
    got = flax_from_state_dict(state.module.state_dict())
    for name, want in (("params", jstate.params),
                       ("batch_stats", jstate.model_state["batch_stats"])):
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(got[name]),
                jax.tree_util.tree_leaves(jax.device_get(want))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
