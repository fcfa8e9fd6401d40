"""The port's ResNet (``encoders/resnet_encoder.py``) against the JAX
package's on converted weights with random batch-norm statistics.

Version 1 and 2, basic and bottleneck blocks, in training (batch
statistics, the running ones updated) and in eval: the pooled outputs,
the updated running statistics in fp32 within rtol 1e-5 and atol 1e-5,
every parameter's gradient (of ``sum(outputs * cotangent)``) within 1e-5
of its largest magnitude in eval and 5e-5 in training (the batch
statistics' backward cancels: a batch norm's scale gradient read 1.4e-5
of it), plus 1e-6; the
outputs under bf16 ("mixed") within 2^-6 of their largest magnitude
relative, about two bf16 roundings of it. The cases take the first
conv's asymmetric SAME padding (7x7 stride 2 on 32 pads (2, 3)), the
SAME max pool's (3x3 stride 2 on 16 pads (0, 1) with -inf) and a strided
stage (3x3 stride 2 on 8 pads (0, 1)); torch's symmetric padding, planted
in the conv or in the pool, gives outputs of the same shape and must
read far outside the tolerance. The parameter count of ResNet-50 v2 at
1,000 classes equals the JAX model's (``jax.eval_shape``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders.resnet_encoder import ResNetNet as JaxResNetNet
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import ds2_encoder, resnet_encoder
from openseq2seq_tpu_torch.encoders.resnet_encoder import ResNetNet
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
GRAD_REL = {False: 1e-5, True: 5e-5}
BF16_REL = 2.0 ** -6
B, S = 4, 32

# the same widths throughout, so that the cases share JAX's compiled ops
CASES = {
    "v2-bottleneck": dict(version=2, bottleneck=True, first_num_filters=4),
    "v1-bottleneck": dict(version=1, bottleneck=True, first_num_filters=4),
    "v2-basic": dict(version=2, bottleneck=False, first_num_filters=16),
    "v1-basic": dict(version=1, bottleneck=False, first_num_filters=16),
}


def _config(case):
    return dict(block_sizes=[1, 2], block_strides=[1, 2],
                first_kernel_size=7, first_conv_stride=2, first_pool_size=3, first_pool_stride=2,
                bn_momentum=0.9, **CASES[case])


def _pair(case, dtype=jnp.float32, seed=0):
    """(flax net, its randomized variables, the port's net on them)."""
    cfg = _config(case)
    jnet = JaxResNetNet(dtype=dtype, **cfg)
    x = np.zeros((B, S, S, 3), np.float32)
    variables = randomize(jnet.init(jax.random.PRNGKey(seed), x,
                                    train=False), seed)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    net = ResNetNet(in_shape=(S, S, 3), dtype=tdtype,
                    generator=torch.Generator().manual_seed(0), **cfg)
    net.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, net


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, S, S, 3).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_matches_jax(case, train):
    jnet, variables, net = _pair(case, seed=len(case))
    x = _inputs(len(case) + train)
    ct = np.random.RandomState(7).randn(
        B, net.out_features).astype(np.float32)

    def loss(params):
        out = jnet.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         x, train=train, mutable=["batch_stats"])
        y, new_vars = out
        return jnp.sum(y * ct), (y, new_vars["batch_stats"])

    (_, (want, want_stats)), grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    got = net(torch.from_numpy(x), train)
    (got * torch.from_numpy(ct)).sum().backward()
    assert got.shape == want.shape == (B, net.out_features)
    _close(got.detach().numpy(), want, "outputs")

    # the running statistics: updated in training, untouched in eval
    new = state_dict_from_flax({"batch_stats": want_stats if train
                                else variables["batch_stats"]})
    state = net.state_dict()
    for name, value in new.items():
        if not name.endswith("num_batches_tracked"):
            _close(state[name].numpy(), value.numpy(), name)
    # every gradient, within GRAD_REL of its largest magnitude: a conv
    # kernel's or a batch norm's gradient sums B x H x W products, whose
    # order differs (and in training cancel through the batch statistics)
    want_grads = state_dict_from_flax({"params": grads})
    named = dict(net.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        want_g = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - want_g).max()
        assert err <= GRAD_REL[train] * np.abs(want_g).max() + 1e-6, \
            (name, err)


@pytest.mark.parametrize("case", ["v2-bottleneck", "v1-basic"])
def test_resnet_bf16_matches_jax(case):
    jnet, variables, net = _pair(case, dtype=jnp.bfloat16, seed=3)
    x = _inputs(11)
    want = np.asarray(jnet.apply(variables, x, train=False), np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), False)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_REL, err


def _symmetric(length, kernel, stride, dilation):
    pad = (kernel - 1) * dilation // 2
    return pad, pad


@pytest.mark.parametrize("where", ["conv", "pool"])
def test_symmetric_padding_is_caught(where, monkeypatch):
    """torch's symmetric padding, planted in the convs or in the max
    pool, keeps every shape and reads far outside the tolerance."""
    case = "v2-bottleneck"
    jnet, variables, net = _pair(case, seed=5)
    x = _inputs(5)
    want = np.asarray(jnet.apply(variables, x, train=False))
    module = ds2_encoder if where == "conv" else resnet_encoder
    monkeypatch.setattr(module, "same_padding", _symmetric)
    with torch.no_grad():
        got = net(torch.from_numpy(x), False).numpy()
    assert got.shape == want.shape
    excess = np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)))
    assert excess > 100.0, excess


def test_resnet50_v2_parameter_count_equals_jax():
    """ResNet-50 v2 with the 1,000-way ``fully_connected`` layer, as in
    ``resnet50_v2_synthetic.py``: the port's parameter count equals the
    JAX model's."""
    jnet = JaxResNetNet(block_sizes=[3, 4, 6, 3], block_strides=[1, 2, 2, 2],
                        version=2, bottleneck=True, first_num_filters=64,
                        first_kernel_size=7, first_conv_stride=2,
                        first_pool_size=3, first_pool_stride=2,
                        bn_momentum=0.997, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(v.shape)) for v in
               jax.tree_util.tree_leaves(shapes["params"]))
    want += 2048 * 1000 + 1000                       # fully_connected
    net = ResNetNet(in_shape=(224, 224, 3), block_sizes=[3, 4, 6, 3],
                    block_strides=[1, 2, 2, 2], version=2, bottleneck=True,
                    first_num_filters=64, first_kernel_size=7,
                    first_conv_stride=2, first_pool_size=3,
                    first_pool_stride=2, bn_momentum=0.997,
                    dtype=torch.bfloat16, generator=torch.Generator())
    got = sum(p.numel() for p in net.parameters()) + 2048 * 1000 + 1000
    assert got == want == RESNET50_V2_PARAMS, (got, want)


RESNET50_V2_PARAMS = 25549352
