"""The port's LSTM language model against the JAX package's: the synthetic
LM data layer; the encoder (``LMNet``) on converted weights, fp32 and
"mixed", on the fused recurrence and on the scan, with LSTM and GRU cells;
the tiny ``LSTMLM`` of ``example_configs_torch/lm/lstm_lm_tiny_synthetic.py``
through ``eval_step``; the full-softmax loss; the sampled-softmax estimator
given the JAX loss's own candidates, loss and gradients; log_q over
WikiText-103's vocabulary (C4); the candidate sampler's law; and the
converter's round trip through the LM's tree, tied and untied.

The JAX side runs its fused recurrence on its Pallas kernels in interpret
mode (``FORCE_INTERPRET``, put back by the fixtures), the port its
kernels' plain versions.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on the encoder's outputs and
logits (an embedding, two recurrent layers and a 1000-wide product summed
in another order), 1e-5 relative on losses, 1e-5 relative and 1e-7
absolute on the sampled softmax's gradients; "mixed" (bf16 compute): the
layers' outputs within 3 bf16 ulps of max(1, |value|) and a mean error of
1e-3, as ``test_torch_rnn.py`` holds its cells (the frameworks round at
the same places, but a sum in another order can flip one rounding, which
the recurrence carries), and the fp32 logits computed from them to the
same tolerance; argmax ids exact in fp32."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from openseq2seq_tpu.data.synthetic import \
    SyntheticLMDataLayer as JaxSyntheticLM
from openseq2seq_tpu.decoders import FakeDecoder as JaxFakeDecoder
from openseq2seq_tpu.encoders import LMEncoder as JaxLMEncoder
from openseq2seq_tpu.losses import \
    BasicSampledSequenceLoss as JaxSampledLoss
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu.models import LSTMLM as JaxLSTMLM
from openseq2seq_tpu.ops import gru_pallas, lstm_pallas
from openseq2seq_tpu.parts.rnns.rnn import fused_rnn_config
from openseq2seq_tpu_torch.convert import (flax_from_state_dict, flax_path,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.data.synthetic import SyntheticLMDataLayer
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.losses.sequence_loss import (
    log_q, log_uniform_candidates, sampled_softmax_nll)
from openseq2seq_tpu_torch.models.model import _named_params
from openseq2seq_tpu_torch.ops import lstm_scan
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "example_configs_torch", "lm",
                    "lstm_lm_tiny_synthetic.py")
B, T, V = 8, 16, 1000
LENGTHS = np.array([16, 15, 9, 1, 16, 12, 4, 16], np.int32)
BF16_ULP = 2.0 ** -7
WKT103_VOCAB = 267744


def _port_params(**overrides):
    params = dict(runpy.run_path(TINY)["base_params"], **overrides)
    params["encoder_params"] = dict(params["encoder_params"])
    return params


def _jax_params(params):
    """The port's config with the JAX package's classes."""
    return dict(params, encoder=JaxLMEncoder, decoder=JaxFakeDecoder,
                loss=JaxSampledLoss, data_layer=JaxSyntheticLM)


def _enc_params(cell):
    p = dict(_port_params()["encoder_params"], vocab_size=V, end_token=1,
             batch_size=B)
    if cell == "gru":
        p["cudnn_rnn_type"] = "cudnn_gru"
    return p


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def _interpret():
    gru_pallas.FORCE_INTERPRET = lstm_pallas.FORCE_INTERPRET = True


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_data_layer_matches_jax(mode):
    params = {"vocab_size": V, "bptt": 12, "num_batches": 3,
              "batch_size": 5, "mode": mode}
    got = list(SyntheticLMDataLayer(dict(params), None).iterate_one_epoch())
    want = list(JaxSyntheticLM(dict(params), None).iterate_one_epoch())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("source_tensors", "target_tensors"):
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["source_tensors"][0][:, 1:],
                                      g["target_tensors"][0][:, :-1])


def _encoders(cell, dtype):
    """(JAX module, its randomized variables, port encoder module on the
    same weights)."""
    enc_params = dict(_enc_params(cell), dtype=dtype)
    jenc = JaxLMEncoder(enc_params, model=None, mode="eval").make_module()
    inputs = {"source_tensors": [jnp.asarray(_ids()), jnp.asarray(LENGTHS)]}
    variables = randomize(dict(jenc.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        inputs, train=False)), seed=2)
    enc = LMEncoder(enc_params, None, mode="eval").make_module(
        0, torch.Generator().manual_seed(0))
    return jenc, variables, enc


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("path", ["fused", "scan"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_encoder_matches_jax(cell, path, dtype):
    jenc, variables, enc = _encoders(cell, dtype)
    fused = path == "fused"
    for layer in (enc.net.rnn1, enc.net.rnn2):
        layer.fused = fused
    enc.load_state_dict(state_dict_from_flax(variables))
    inputs = {"source_tensors": [jnp.asarray(_ids()), jnp.asarray(LENGTHS)]}
    _interpret()
    with fused_rnn_config(fused):
        want = jax.jit(lambda v, i: jenc.apply(v, i, train=False))(
            variables, inputs)
    launches = lstm_scan.LAUNCHES
    with torch.no_grad():
        got = enc({"source_tensors": [torch.from_numpy(_ids()),
                                      torch.from_numpy(LENGTHS)]}, False)
    assert lstm_scan.LAUNCHES == launches
    assert got["logits"].dtype == torch.float32
    assert got["logits"].shape == (B, T, V)
    outs, jouts = got["outputs"].float().numpy(), \
        np.asarray(want["outputs"], np.float32)
    logits, jlogits = got["logits"].numpy(), np.asarray(want["logits"])
    if dtype == "float32":
        np.testing.assert_allclose(outs, jouts, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(logits.argmax(-1),
                                      jlogits.argmax(-1))
        return
    assert got["outputs"].dtype == torch.bfloat16
    for g, w in ((outs, jouts), (logits, jlogits)):
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert err.mean() <= 1e-3 and err.max() <= 3 * BF16_ULP, (
            err.mean(), err.max())


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, V, (B, T + 1)).astype(
        np.int32)
    return {"source_tensors": [ids[:, :-1].copy(), LENGTHS.copy()],
            "target_tensors": [ids[:, 1:].copy(), LENGTHS.copy()],
            "source_ids": np.arange(B, dtype=np.int32),
            "batch_valid": np.int32(B)}


def test_eval_step_matches_jax():
    """The tiny config in eval: the loss (the full softmax over the valid
    tokens) and the argmax ids; the logits never leave the model."""
    batch = _batch()
    params = _port_params()
    jmodel = JaxLSTMLM(_jax_params(params), mode="eval")
    jstate = jmodel.init_state(batch)
    _interpret()
    variables = randomize({"params": jstate.params}, seed=3)
    jstate = jstate.replace(params=variables["params"])
    jout = jax.device_get(jmodel.eval_step(jstate, batch))
    model = runpy.run_path(TINY)["base_model"](params, mode="eval",
                                               device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    out = to_host(model.eval_step(state, batch))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    dec = out["outputs"]["decoder_output"]
    assert set(dec) == {"ids", "src_length"}
    np.testing.assert_array_equal(
        dec["ids"], np.asarray(jout["outputs"]["decoder_output"]["logits"])
        .argmax(-1))
    tokens = int(LENGTHS.sum())
    assert model.evaluate(batch, out) == pytest.approx(
        (float(out["loss"]) * tokens, tokens))
    metrics = model.finalize_evaluation([model.evaluate(batch, out)])
    assert metrics["Eval perplexity"] == pytest.approx(
        np.exp(float(jout["loss"])), rel=1e-5)


@pytest.mark.parametrize("offset,average", [(False, True), (True, False)])
def test_basic_sequence_loss_matches_jax(offset, average):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(B, T, V)).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    params = {"tgt_vocab_size": V, "batch_size": B,
              "offset_target_by_one": offset,
              "average_across_timestep": average}
    inputs = {"decoder_output": {"logits": logits},
              "target_tensors": [labels, LENGTHS]}
    want = JaxSequenceLoss(dict(params), None).compute_loss(
        jax.tree_util.tree_map(jnp.asarray, inputs))
    t = torch.from_numpy(logits).requires_grad_()
    got = BasicSequenceLoss(dict(params), None).compute_loss({
        "decoder_output": {"logits": t},
        "target_tensors": [torch.from_numpy(labels),
                           torch.from_numpy(LENGTHS)]})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    jgrad = jax.grad(lambda x: JaxSequenceLoss(dict(params), None)
                     .compute_loss({"decoder_output": {"logits": x},
                                    "target_tensors": [labels, LENGTHS]}))(
        jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-9)


def _jax_candidates(key, labels, S):
    """The JAX loss's candidates for ``labels`` (its own jax.random
    calls, ``sequence_loss.py:210-216``)."""
    key = jax.random.fold_in(key, jnp.sum(jnp.asarray(labels).reshape(-1)))
    u = jax.random.uniform(key, (S,), minval=0.0, maxval=1.0)
    return np.asarray(jnp.clip(
        jnp.floor(jnp.exp(u * jnp.log(float(V) + 1.0))) - 1.0,
        0, V - 1).astype(jnp.int32))


def test_sampled_softmax_matches_jax_given_its_candidates():
    """Loss and gradients with respect to the inputs, the weights and the
    bias, against ``jax.grad`` of the JAX loss; labels include small ids,
    so that some candidate is an accidental hit."""
    rng = np.random.RandomState(5)
    H, S = 24, 64
    inputs = rng.randn(B, T, H).astype(np.float32)
    weights = (0.3 * rng.randn(V, H)).astype(np.float32)
    bias = (0.1 * rng.randn(V)).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    labels[:, ::3] = rng.randint(0, 8, labels[:, ::3].shape)
    key = jax.random.PRNGKey(7)
    sampled = _jax_candidates(key, labels, S).copy()
    hits = np.isin(labels[np.arange(T)[None, :] < LENGTHS[:, None]],
                   sampled)
    assert hits.sum() > 0
    loss = JaxSampledLoss({"tgt_vocab_size": V, "batch_size": B,
                           "offset_target_by_one": False,
                           "average_across_timestep": True}, None)

    def jax_loss(x, w, b):
        return loss.compute_loss({
            "decoder_output": {"weights": w, "bias": b, "inputs": x,
                               "num_sampled": S, "sample_rng": key},
            "target_tensors": [jnp.asarray(labels), jnp.asarray(LENGTHS)]})
    want, jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(inputs), jnp.asarray(weights), jnp.asarray(bias))
    tensors = [torch.from_numpy(a).requires_grad_()
               for a in (inputs, weights, bias)]
    got = sampled_softmax_nll(*tensors, torch.from_numpy(labels),
                              torch.from_numpy(LENGTHS),
                              torch.from_numpy(sampled), V)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    for t, g in zip(tensors, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_log_q_finite_over_wkt103():
    """C4, the twin of ``tests/test_lm.py``'s: log_q is finite for every
    id below 267,744, and exp(log_q) sums to 1."""
    lq = log_q(torch.arange(WKT103_VOCAB), WKT103_VOCAB)
    assert lq.dtype == torch.float32 and bool(torch.isfinite(lq).all())
    assert abs(float(lq.double().exp().sum()) - 1.0) < 1e-3


def test_sampler_follows_the_log_uniform_law():
    """200,000 candidates over WikiText-103's vocabulary in 16 log-spaced
    bins, against q(k) = log((k + 2) / (k + 1)) / log(V + 1), whose mass
    on [a, b) is log((b + 1) / (a + 1)) / log(V + 1): the chi-square
    statistic below its 0.1% critical value (fixed seed)."""
    n = 200_000
    ids = log_uniform_candidates(n, WKT103_VOCAB,
                                 torch.Generator().manual_seed(11),
                                 "cpu").numpy()
    assert ids.min() >= 0 and ids.max() < WKT103_VOCAB
    edges = np.unique(np.round(np.geomspace(1, WKT103_VOCAB + 1, 17)) - 1
                      ).astype(np.int64)
    counts = np.histogram(ids, bins=edges)[0]
    mass = np.log((edges[1:] + 1.0) / (edges[:-1] + 1.0)) / \
        np.log(WKT103_VOCAB + 1.0)
    stat = float(np.sum((counts - n * mass) ** 2 / (n * mass)))
    assert stat < scipy.stats.chi2.ppf(0.999, len(counts) - 1), stat


@pytest.mark.parametrize("tied", [False, True])
def test_convert_round_trip(tied):
    """The port's parameters carry the JAX tree's names and shapes
    (``embedding``, ``rnn{i}/input_proj``, ``rnn{i}/recurrent_kernel``,
    the untied ``softmax/kernel`` (E, V) or the tied ``softmax_bias``),
    and the converter maps the JAX variables onto them and back."""
    params = _port_params()
    params["encoder_params"]["weight_tied"] = tied
    batch = _batch()
    jmodel = JaxLSTMLM(_jax_params(params), mode="eval")
    jparams = jax.device_get(jmodel.init_state(batch).params)
    variables = randomize({"params": jparams}, seed=6)
    model = runpy.run_path(TINY)["base_model"](params, mode="eval",
                                               device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    names = {"/".join(path) for path, _ in _named_params(state.module)}
    flat = _flatten(variables["params"])
    assert names == set(flat)
    assert ("enc/net/softmax_bias" in names) == tied
    assert ("enc/net/softmax/kernel" in names) != tied
    back = flax_from_state_dict(state.module.state_dict())["params"]
    for name, value in _flatten(back).items():
        np.testing.assert_array_equal(value, flat[name], err_msg=name)
    assert flax_path("enc.net.softmax.weight", set()) == (
        "enc", "net", "softmax", "kernel")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_refused_options():
    """What the port refuses: skip connections (the JAX package ignores
    them), ``fc_use_bias`` False and ``core_cell_params`` with no effect
    (both ignored there too), and ``generate`` without a WikiText-style
    vocabulary (the synthetic data layer has none)."""
    with pytest.raises(NotImplementedError, match="skip_connections"):
        LMEncoder(dict(_enc_params("lstm"),
                       encoder_use_skip_connections=True), None)
    with pytest.raises(ValueError, match="fc_use_bias"):
        LMEncoder(dict(_enc_params("lstm"), fc_use_bias=False), None)
    with pytest.raises(ValueError, match="no effect"):
        LMEncoder(dict(_enc_params("lstm"), core_cell_params={
            "num_units": 8, "forget_bias": 0.5}), None)
    with pytest.raises(ValueError, match="Unknown config parameter"):
        LMEncoder(dict(_enc_params("lstm"), sampling_prob=0.5), None)
    model = runpy.run_path(TINY)["base_model"](_port_params(), mode="eval",
                                               device="cpu")
    with pytest.raises(ValueError, match="Corpus"):
        model.generate(None)
