"""The port's TDNN encoder against the JAX package's, on the same
converted weights, at a Jasper shape cut to 2 blocks x 2 sub-layers and
1/8 width, in eval mode with non-trivial batch-norm statistics and odd
lengths (the stride-2 prologue's SAME pad is asymmetric for an even
frame count and symmetric for an odd one). In train mode with dropout
off: the outputs and the updated batch-norm statistics after one forward,
at B=2 and T=20 where the unbiased variance's n / (n - 1) shows, and the
stochastic block drop at probability 1. Then the port's dropout: its keep
rate (within 4 sigma over 2e5 elements) and its exact rescale for
``dropout_bits`` 8 and 32, drawn from the generator it is given alone.

Tolerance: fp32, rtol 1e-5 and atol 1e-5; output lengths exact."""
import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders import TDNNEncoder as JaxTDNNEncoder
from openseq2seq_tpu.parts.initializers import \
    resolve_initializer as jax_resolve_initializer
from openseq2seq_tpu.zoo import jasper_convnet_layers
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.encoders.tdnn_encoder import BatchNorm
from openseq2seq_tpu_torch.parts.dropout import dropout, keep_spec, step_seed
from openseq2seq_tpu_torch.parts.initializers import resolve_initializer
from test_torch_text_data import one_thread  # noqa: F401

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


def _train_params(**extra):
    """Jasper layers with every dropout off."""
    params = dict(_params(jax.nn.relu), dropout_keep_prob=1.0, **extra)
    params["convnet_layers"] = [dict(layer, dropout_keep_prob=1.0)
                                for layer in params["convnet_layers"]]
    return params


@pytest.mark.parametrize("drop_block_prob", [0.0, 1.0])
def test_train_forward_and_bn_statistics_match_jax(drop_block_prob):
    """One train-mode forward: outputs, and the running mean and variance
    updated from the biased batch statistics as flax does (torch's own
    update takes the unbiased variance, 5% off at n = 2 x 10 frames). At
    ``drop_block_prob`` 1 every residual block passes its residual sum
    alone, on both sides."""
    rng = np.random.RandomState(20)
    x = rng.randn(2, 20, FEATURES).astype(np.float32)
    lengths = np.array([20, 15], np.int32)
    jparams = _train_params(drop_block_prob=drop_block_prob)
    jmod = JaxTDNNEncoder(jparams, model=None, mode="train").make_module()
    jin = {"source_tensors": [x, lengths]}
    variables = randomize(jmod.init(jax.random.PRNGKey(0), jin,
                                    train=False), seed=20)
    want, new_vars = jmod.apply(variables, jin, train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(1)})

    tparams = dict(jparams, activation_fn="relu")
    module = TDNNEncoder(tparams, model=None, mode="train") \
        .make_module(FEATURES, torch.Generator().manual_seed(0))
    module.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = module({"source_tensors": [torch.from_numpy(x),
                                         torch.from_numpy(lengths)]},
                     train=True, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]),
                               rtol=RTOL, atol=ATOL)
    stats = flax_from_state_dict(module.state_dict())["batch_stats"]
    want_stats = jax.tree_util.tree_map(np.asarray, new_vars["batch_stats"])
    flat = jax.tree_util.tree_leaves_with_path(want_stats)
    assert flat
    for path, value in flat:
        leaf = stats
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, value, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bits,keep,p", [(32, 0.8, 0.8), (32, 0.7, 0.7),
                                         (8, 0.8, 205 / 256),
                                         (8, 0.7, 179 / 256)])
def test_dropout_keep_rate_and_rescale(bits, keep, p):
    """``dropout_bits`` 8 keeps with probability t/256, t = round(keep *
    256), and rescales by the same t/256; 32 keeps with ``keep`` and
    rescales by it."""
    assert keep_spec(keep, bits) == (p, p)
    n = 200_000
    x = torch.ones(n)
    global_rng = torch.get_rng_state()
    y = dropout(x, keep, torch.Generator().manual_seed(3), bits)
    assert torch.equal(torch.get_rng_state(), global_rng)
    kept = y != 0
    rate = float(kept.float().mean())
    assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n), (rate, p)
    assert torch.all(y[kept] == torch.tensor(1.0) / p)
    # the same seed draws the same mask; keep 1 is the identity
    assert torch.equal(y, dropout(x, keep, torch.Generator().manual_seed(3),
                                  bits))
    assert dropout(x, 1.0, None, bits) is x


def test_step_seeds_differ_and_repeat():
    seeds = [step_seed(0, s) for s in range(1000)] + \
        [step_seed(1, s) for s in range(1000)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert step_seed(7, 12) == step_seed(7, 12)
