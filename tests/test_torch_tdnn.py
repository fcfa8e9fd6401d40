"""The port's TDNN encoder against the JAX package's, on the same
converted weights, at a Jasper shape cut to 2 blocks x 2 sub-layers and
1/8 width, in eval mode with non-trivial batch-norm statistics and odd
lengths (the stride-2 prologue's SAME pad is asymmetric for an even
frame count and symmetric for an odd one).

Tolerance: fp32, rtol 1e-5 and atol 1e-5; output lengths exact."""
import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders import TDNNEncoder as JaxTDNNEncoder
from openseq2seq_tpu.parts.initializers import \
    resolve_initializer as jax_resolve_initializer
from openseq2seq_tpu.zoo import jasper_convnet_layers
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.encoders.tdnn_encoder import BatchNorm
from openseq2seq_tpu_torch.parts.initializers import resolve_initializer

RTOL = ATOL = 1e-5
FEATURES = 16


def _params(activation):
    return {"convnet_layers": jasper_convnet_layers(2, 2, width_scale=0.125),
            "dropout_keep_prob": 0.7, "initializer": "xavier_normal",
            "normalization": "batch_norm", "activation_fn": activation,
            "use_conv_mask": True}


def randomize(variables, seed):
    """Replace biases, batch-norm scales and statistics (all init to 0 or
    1) with random values, so that a wrong mapping shows."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(jax.tree_util.tree_map(np.asarray, dict(variables)))


@pytest.mark.parametrize("T", [36, 37])
def test_tdnn_matches_jax(T):
    rng = np.random.RandomState(T)
    x = rng.randn(3, T, FEATURES).astype(np.float32)
    lengths = np.array([T, T - 6, 11], np.int32)

    jmod = JaxTDNNEncoder(_params(jax.nn.relu), model=None,
                          mode="eval").make_module()
    jin = {"source_tensors": [x, lengths]}
    variables = randomize(jmod.init(jax.random.PRNGKey(0), jin,
                                    train=False), seed=T)
    want = jmod.apply(variables, jin, train=False)

    module = TDNNEncoder(_params("relu"), model=None, mode="eval") \
        .make_module(FEATURES, torch.Generator().manual_seed(0))
    module.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = module({"source_tensors": [torch.from_numpy(x),
                                         torch.from_numpy(lengths)]},
                     train=False)
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  np.asarray(want["src_length"]))
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]),
                               rtol=RTOL, atol=ATOL)


def test_batchnorm_constants():
    """flax momentum 0.90 (decay of the running mean) is torch's 0.10
    (weight of the new batch); eps is 1e-3, not torch's 1e-5."""
    module = TDNNEncoder(_params("relu"), model=None, mode="eval") \
        .make_module(FEATURES, torch.Generator().manual_seed(0))
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    assert norms
    for bn in norms:
        assert bn.momentum == pytest.approx(0.10)
        assert bn.eps == pytest.approx(1e-3)


@pytest.mark.parametrize("name,shape", [("xavier_normal", (96, 48, 11)),
                                        ("xavier_uniform", (29, 128))])
def test_initializer_matches_jax_distribution(name, shape):
    """Same distribution as JAX's: xavier_normal is a normal truncated
    at two standard deviations (bounded, and with the target variance),
    xavier_uniform a uniform; and a seeded generator repeats itself."""
    torch_init = resolve_initializer(name)
    w = torch.empty(shape)
    torch_init(w, torch.Generator().manual_seed(1))
    w2 = torch.empty(shape)
    torch_init(w2, torch.Generator().manual_seed(1))
    assert torch.equal(w, w2)
    # JAX kernel layout: conv (k, in, out), dense (in, out)
    jax_shape = shape[::-1]
    jw = np.asarray(jax_resolve_initializer(name)(jax.random.PRNGKey(1),
                                                  jax_shape))
    w = w.numpy()
    np.testing.assert_allclose(w.std(), jw.std(), rtol=0.03)
    np.testing.assert_allclose(np.abs(w).max(), np.abs(jw).max(), rtol=0.03)
