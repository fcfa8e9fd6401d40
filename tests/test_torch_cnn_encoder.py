"""The port's CNN encoder (``encoders/cnn_encoder.py``) against the JAX
package's ``CNNNet`` on converted weights: every layer kind (SAME and
VALID convs with a bias, SAME and VALID max and average pools, batch
norm, dense, flatten, dropout) and both spec forms (dicts and
``(name, params)`` tuples), the layers named ``"{type}_{index}"`` over
the combined list. fp32 in eval and in training (batch statistics, the
running ones updated): outputs and running statistics within rtol 1e-5,
atol 1e-5, every gradient within 1e-5 of its largest magnitude (5e-5 in
training), plus 1e-6. Dropout draws from the explicit generator with the
model's ``dropout_bits``. Symmetric padding planted in the SAME pools
reads far outside the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders.cnn_encoder import CNNNet as JaxCNNNet
from openseq2seq_tpu_torch.convert import flax_path, state_dict_from_flax
from openseq2seq_tpu_torch.encoders import resnet_encoder
from openseq2seq_tpu_torch.encoders.cnn_encoder import CNNNet
from openseq2seq_tpu_torch.encoders.tdnn_encoder import same_padding
from openseq2seq_tpu_torch.models.model import _named_params
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
GRAD_REL = {False: 1e-5, True: 5e-5}
B, H, W = 4, 20, 20

CNN_LAYERS = [
    {"type": "conv2d", "filters": 8, "kernel_size": 3, "strides": 2,
     "activation": "relu"},
    ("max_pooling2d", {"pool_size": 3, "strides": 2, "padding": "SAME"}),
    {"type": "batch_norm", "momentum": 0.9, "epsilon": 1e-4},
    {"type": "conv2d", "filters": 16, "kernel_size": [3, 2], "strides": 1,
     "padding": "VALID", "activation": "tanh"},
    {"type": "avg_pool", "pool_size": 2, "strides": 1, "padding": "SAME"},
    ("average_pooling2d", {"pool_size": 2}),
    {"type": "max_pool", "pool_size": 1, "strides": 1},
]
FC_LAYERS = [
    {"type": "dense", "units": 16, "activation": "relu"},
    {"type": "dropout", "rate": 0.0},
    {"type": "flatten"},
    {"type": "dense", "units": 8},
]


def _pair(seed):
    jnet = JaxCNNNet(cnn_layers=tuple(CNN_LAYERS), fc_layers=tuple(FC_LAYERS),
                     dtype=jnp.float32)
    x = np.zeros((B, H, W, 3), np.float32)
    variables = randomize(jnet.init(jax.random.PRNGKey(seed), x,
                                    train=False), seed)
    net = CNNNet((H, W, 3), CNN_LAYERS + FC_LAYERS, torch.float32, 32,
                 torch.Generator().manual_seed(0))
    net.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, net


def test_layer_names_follow_the_flax_module():
    _, variables, net = _pair(0)
    assert sorted(variables["params"]) == ["batch_norm_3", "conv2d_1",
                                           "conv2d_4", "dense_11",
                                           "dense_8"]
    paths = {"/".join(p) for p, _ in _named_params(net)}
    assert "batch_norm_3/scale" in paths and "conv2d_1/bias" in paths
    assert flax_path("batch_norm_3.running_var", {"batch_norm_3"}) == \
        ("batch_norm_3", "var")
    assert net.out_features == 8


@pytest.mark.parametrize("train", [False, True])
def test_cnn_matches_jax(train):
    jnet, variables, net = _pair(1)
    rng = np.random.RandomState(2 + train)
    x = rng.randn(B, H, W, 3).astype(np.float32)
    ct = rng.randn(B, 8).astype(np.float32)

    def loss(params):
        y, new = jnet.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            x, train=train, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, new["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    got = net(torch.from_numpy(x), train, torch.Generator())
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    state = net.state_dict()
    for name, value in state_dict_from_flax(
            {"batch_stats": stats}).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    want_grads = state_dict_from_flax({"params": grads})
    for name, p in net.named_parameters():
        g = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= GRAD_REL[train] * np.abs(g).max() + 1e-6, (name, err)


@pytest.mark.parametrize("bits", [8, 32])
def test_dropout_draws_from_the_generator(bits):
    """A dense layer's output through dropout 0.5: kept values scaled by
    the keep probability of ``dropout_bits`` (8: t / 256), the rest zero,
    the same mask again from the same seed, none in eval."""
    layers = [{"type": "dense", "units": 64}, {"type": "dropout",
                                               "rate": 0.5}]
    net = CNNNet((2, 2, 3), layers, torch.float32, bits,
                 torch.Generator().manual_seed(0))
    x = torch.randn(8, 2, 2, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = net.dense_1(x.reshape(8, -1))
        a = net(x, True, torch.Generator().manual_seed(5))
        b = net(x, True, torch.Generator().manual_seed(5))
        assert torch.equal(net(x, False), plain)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.3 < kept.float().mean() < 0.7
    q = 128 / 256 if bits == 8 else 0.5
    torch.testing.assert_close(a[kept], plain[kept] / q)


def _symmetric(length, kernel, stride, dilation):
    """torch's ``padding=(k - 1) // 2`` on both sides for odd windows (the
    3x3 stride-2 max pool: (1, 1) where XLA pads (0, 1)); even windows,
    which no symmetric pad fits, as XLA pads them."""
    if kernel % 2 == 0:
        return same_padding(length, kernel, stride, dilation)
    return (kernel - 1) // 2, (kernel - 1) // 2


def test_symmetric_pool_padding_is_caught(monkeypatch):
    jnet, variables, net = _pair(4)
    x = np.random.RandomState(4).randn(B, H, W, 3).astype(np.float32)
    want = np.asarray(jnet.apply(variables, x, train=False))
    monkeypatch.setattr(resnet_encoder, "same_padding", _symmetric)
    with torch.no_grad():
        got = net(torch.from_numpy(x), False).numpy()
    assert got.shape == want.shape
    excess = np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)))
    assert excess > 100.0, excess
