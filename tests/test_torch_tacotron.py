"""The port's Tacotron-2 against the JAX package's, on the same inputs
(from numpy with fixed seeds) and converted weights (every leaf moved by
N(0, 0.05^2), so that zero-initialized biases and a wrong mapping show):

  * the encoder, with and without GST, in training (batch statistics,
    dropout off) and eval: outputs, the gradients of a weighted sum of
    them and the updated batch statistics, fp32; its recurrences on the
    fused path (the LSTM and GRU kernels' plain versions, at the narrow
    fp32 width of 64 they take on the CPU) and on the scan; "mixed" (bf16
    compute) outputs too;
  * the decoder under teacher forcing with zoneout 0 and every prenet
    mask set to keep (``jax.random.bernoulli`` patched on the JAX side,
    ``keep_mask`` on the port's): the outputs and the gradients of the
    TTS loss; the deterministic zoneout blend in eval; ``outputs_per_step``
    3; Bahdanau attention; free-running infer over 12 steps, with equal
    lengths;
  * the loss alone, L2 and L1, masked and not;
  * two Adam + clipping train steps of the tiny config, leaf by leaf;
  * the converter's round trip, the full-width parameter counts by
    ``jax.eval_shape`` (and ``chip_smoke.py``'s copies of them), and C24;
  * ``run.main`` on the tiny config in train, eval and infer;
  * (slow) the toy recipe from wav files to a loss below 12.0.

Tolerance: fp32 rtol 1e-5 (outputs) and 1e-4 (gradients, weights after
the Adam steps, as ``test_torch_jasper_train.py``), atol 1e-6 (1e-5 for
the decoder's outputs, whose attention sums over every source step; for
a gradient, 1e-5 of its leaf's largest magnitude); the biases of the
convs that feed a batch norm, whose gradient is zero in exact
arithmetic, held to zero on both sides (and frozen in the train steps);
"mixed": each output within 2^-5 of max(1, |value|), four bf16 ulps of
the compute type's rounding carried through the conv, batch norm and
recurrence in another order.
"""
import copy
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openseq2seq_tpu import decoders as jax_decoders
from openseq2seq_tpu import encoders as jax_encoders
from openseq2seq_tpu import losses as jax_losses
from openseq2seq_tpu import models as jax_models
from openseq2seq_tpu.data.synthetic import \
    SyntheticTTSDataLayer as JaxSyntheticTTS
from openseq2seq_tpu_torch import decoders, encoders, losses, run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           optimizer_state_from_optax,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.decoders.tacotron2_decoder import \
    Tacotron2DecoderModule
from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
from openseq2seq_tpu_torch.parts.rnns.rnn import GRU, LSTM
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_jasper_train import ATOL, RTOL, _assert_tree_close
# torch on one thread
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2speech")
TINY = os.path.join(CONFIGS, "tacotron_tiny_synthetic.py")
TOY = os.path.join(CONFIGS, "tacotron_toy.py")
B, S, T, F, V = 3, 10, 14, 6, 9
SRC_LEN = np.array([10, 4, 7], np.int32)
SPEC_LEN = np.array([14, 9, 5], np.int32)
GST = {"num_tokens": 4, "num_units": 8, "attention_heads": 2,
       "conv_layers": [4, 4], "num_rnn_units": 64}


def _leaves_perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, dict(variables)))


def _perturbed_weights(module, seed):
    """The port module's weights and statistics, perturbed, loaded back
    into it, and as flax variables for the JAX module."""
    variables = _leaves_perturbed(flax_from_state_dict(module.state_dict()),
                                  seed)
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])
    module.load_state_dict(state_dict_from_flax(variables))
    return {k: v for k, v in variables.items() if v}


def _grads(module):
    """The gradients as a flax tree (the statistics name the norms)."""
    tree = {n: p.grad for n, p in module.named_parameters()}
    tree.update(module.named_buffers())
    return flax_from_state_dict(tree)["params"]


# the biases of the convs that feed a batch norm: the norm removes them,
# so their gradient is zero in exact arithmetic and rounding noise in
# either framework (``test_torch_jasper_train.py`` freezes such biases)
PRE_NORM_BIAS = r"/(conv|ref_conv|postnet_conv)[0-9]+/bias$"
# so is the GST keys' bias's: it adds the same q . b to every token's
# score of a head, which the softmax removes
ZERO_GRAD = PRE_NORM_BIAS + r"|/style_k/bias$"


# a gradient's element is also allowed 1e-5 of its leaf's largest
# magnitude: the conv and batch-norm backward sum B T terms in another
# order, whose cancellation leaves small elements with less relative
# precision
GRAD_ATOL = 1e-5


def _assert_grads_close(got, want):
    """Leaf by leaf, the leaves of ``ZERO_GRAD`` held to zero on both
    sides, the rest close."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = "/" + "/".join(k.key for k in path)
        g = flat_got[path]
        if re.search(ZERO_GRAD, name):
            scale = max(np.abs(np.asarray(v)).max()
                        for v in jax.tree_util.tree_leaves(want))
            assert np.abs(g).max() <= 1e-5 * scale, name
            assert np.abs(np.asarray(w)).max() <= 1e-5 * scale, name
        else:
            w = np.asarray(w)
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=GRAD_ATOL * np.abs(w).max(),
                err_msg=name)


def _stats(module):
    return flax_from_state_dict(module.state_dict())["batch_stats"]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _enc_params(gst, **extra):
    params = {"cnn_dropout_prob": 0.0, "rnn_dropout_prob": 0.0,
              "src_emb_size": 16, "src_vocab_size": V,
              "conv_layers": [{"kernel_size": [5], "stride": [1],
                               "num_channels": 12, "padding": "SAME"},
                              {"kernel_size": [3], "stride": [1],
                               "num_channels": 8, "padding": "SAME"}],
              "activation_fn": "relu", "num_rnn_layers": 1,
              "rnn_cell_dim": 64, "use_cudnn_rnn": True, "rnn_type": "lstm",
              "rnn_unidirectional": False, "zoneout_prob": 0.1}
    if gst:
        params.update(style_embedding_enable=True,
                      style_embedding_params=GST)
    params.update(extra)
    return params


def _enc_inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    spec = rng.randn(B, T, F).astype(np.float32)
    return ids, spec


def _set_fused(module, fused):
    for m in module.modules():
        if isinstance(m, (LSTM, GRU)):
            m.fused = fused


@pytest.mark.parametrize("gst", [False, True], ids=["plain", "gst"])
def test_encoder_matches_jax(gst, monkeypatch):
    """Training (batch statistics) outputs, the gradients of a weighted
    sum of them and the new statistics, then eval outputs, on the fused
    recurrences and on the scan."""
    params = _enc_params(gst)
    jenc = jax_encoders.Tacotron2Encoder(params, None).make_module()
    enc = encoders.Tacotron2Encoder(params, None).make_module(
        F, torch.Generator().manual_seed(0))
    variables = _perturbed_weights(enc, seed=1)
    ids, spec = _enc_inputs()
    weights = np.random.RandomState(2).randn(
        B, S, enc.out_features).astype(np.float32)
    jinputs = {"source_tensors": [jnp.asarray(ids), jnp.asarray(SRC_LEN)],
               "target_tensors": [jnp.asarray(spec)]}

    @jax.jit
    def jax_run(v):
        def objective(p):
            out, new = jenc.apply({**v, "params": p}, jinputs, train=True,
                                  mutable=["batch_stats"])
            return jnp.sum(out["outputs"] * weights), (out, new)
        (_, (out, new)), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        ev = jenc.apply(v, jinputs, train=False)
        return out["outputs"], new["batch_stats"], g, ev["outputs"], \
            ev["src_length"]

    want, want_stats, want_grads, want_eval, want_len = jax.device_get(
        jax_run(variables))
    inputs = {"source_tensors": [torch.from_numpy(ids),
                                 torch.from_numpy(SRC_LEN)],
              "target_tensors": [torch.from_numpy(spec)]}
    calls = []
    for kernel, cell in ((lstm_scan, "lstm"), (gru_scan, "gru")):
        fn = getattr(kernel, cell + "_scan")
        monkeypatch.setattr(kernel, cell + "_scan",
                            lambda *a, _fn=fn, **k: calls.append(1) or
                            _fn(*a, **k))
    state = copy.deepcopy(enc.state_dict())
    for fused in (True, False):
        enc.load_state_dict(state)
        _set_fused(enc, fused)
        del calls[:]
        enc.zero_grad(set_to_none=True)
        got = enc(inputs, True)
        (got["outputs"] * torch.from_numpy(weights)).sum().backward()
        np.testing.assert_allclose(got["outputs"].detach().numpy(), want,
                                   rtol=1e-5, atol=ATOL)
        _assert_grads_close(_grads(enc), want_grads)
        _assert_tree_close(_stats(enc), want_stats, "stats")
        enc.load_state_dict(state)
        with torch.no_grad():
            ev = enc(inputs, False)
        np.testing.assert_allclose(ev["outputs"].numpy(), want_eval,
                                   rtol=1e-5, atol=ATOL)
        np.testing.assert_array_equal(ev["src_length"].numpy(), want_len)
        # two LSTM directions (and the GRU) a call, in training and eval
        assert len(calls) == (2 * (3 if gst else 2) if fused else 0)


def test_encoder_mixed_matches_jax():
    """bf16 compute on both sides, GST on: each output within 2^-5 of
    max(1, |value|)."""
    params = _enc_params(True, dtype="mixed")
    jenc = jax_encoders.Tacotron2Encoder(params, None).make_module()
    enc = encoders.Tacotron2Encoder(params, None).make_module(
        F, torch.Generator().manual_seed(3))
    assert enc.net.dtype == torch.bfloat16
    variables = _perturbed_weights(enc, seed=4)
    ids, spec = _enc_inputs(5)
    jinputs = {"source_tensors": [jnp.asarray(ids), jnp.asarray(SRC_LEN)],
               "target_tensors": [jnp.asarray(spec)]}
    want = np.asarray(jax.jit(lambda v: jenc.apply(v, jinputs, train=False)[
        "outputs"])(variables)).astype(np.float32)
    with torch.no_grad():
        got = enc({"source_tensors": [torch.from_numpy(ids),
                                      torch.from_numpy(SRC_LEN)],
                   "target_tensors": [torch.from_numpy(spec)]}, False)
    out = got["outputs"]
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2.0 ** -5, err.max()


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_params(**extra):
    params = {"attention_layer_size": 16, "attention_type": "location",
              "decoder_cell_units": 32, "decoder_cell_type": "lstm",
              "decoder_layers": 2, "enable_prenet": True,
              "prenet_layers": 2, "prenet_units": 12,
              "enable_postnet": True,
              "postnet_conv_layers": [
                  {"kernel_size": [5], "stride": [1], "num_channels": 10,
                   "padding": "SAME"},
                  {"kernel_size": [5], "stride": [1], "num_channels": -1,
                   "padding": "SAME"}],
              "zoneout_prob": 0.0, "mask_decoder_sequence": True,
              "num_audio_features": F, "infer_max_steps": 12}
    params.update(extra)
    return params


def _keep_all(monkeypatch):
    """Every prenet mask keeps, on both sides."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(Tacotron2DecoderModule, "keep_mask",
                        lambda self, shape, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))


def _dec_inputs(E=20, seed=6):
    rng = np.random.RandomState(seed)
    memory = rng.randn(B, S, E).astype(np.float32)
    spec = rng.randn(B, T, F).astype(np.float32)
    stop = (np.arange(T)[None, :] >= SPEC_LEN[:, None] - 1).astype(
        np.float32)
    return memory, [spec, stop, SPEC_LEN]


def _decoders(params, mode, seed=7):
    memory, targets = _dec_inputs()
    jdec = jax_decoders.Tacotron2Decoder(params, None, mode=mode) \
        .make_module()
    dec = decoders.Tacotron2Decoder(params, None, mode=mode).make_module(
        memory.shape[-1], torch.Generator().manual_seed(0))
    variables = _perturbed_weights(dec, seed)
    jin = {"encoder_output": {"outputs": jnp.asarray(memory),
                              "src_length": jnp.asarray(SRC_LEN)}}
    tin = {"encoder_output": {"outputs": torch.from_numpy(memory),
                              "src_length": torch.from_numpy(SRC_LEN)}}
    if mode != "infer":
        jin["target_tensors"] = [jnp.asarray(t) for t in targets]
        tin["target_tensors"] = [torch.from_numpy(t) for t in targets]
    return jdec, variables, jin, dec, tin


def _stop_bias(logits):
    """A stop bias under which the rows of ``logits`` (B, steps; the
    stop logits without bias) first fire at different steps, each logit
    as far from 0 as such a bias allows: the lengths then do not hang on
    a rounding. The logits are not fed back, so the bias moves nothing
    else."""
    values = np.sort(logits.ravel())
    best = None
    for b in -(values[1:] + values[:-1]) / 2:
        fired = logits + b > 0
        lengths = np.where(fired.any(1), fired.argmax(1) + 1,
                           logits.shape[1])
        key = (len(set(lengths.tolist())), np.abs(logits + b).min())
        if best is None or key > best[0]:
            best = (key, b)
    return np.float32(best[1])


OUTPUTS = ("decoder_spec", "post_net_spec", "stop_token_logits",
           "alignments")


def _assert_outputs_close(got, want):
    for key in OUTPUTS:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))


@pytest.mark.parametrize("extra,grads", [
    ({}, True), ({"outputs_per_step": 3}, False),
    ({"attention_type": "bahdanau"}, False)],
    ids=["location", "r3", "bahdanau"])
def test_decoder_teacher_forced_matches_jax(extra, grads, monkeypatch):
    """Training (the postnet's batch statistics): the outputs, the TTS
    loss and the new statistics; with location-sensitive attention at
    r = 1 also the loss's gradients (r = 3 and Bahdanau change the
    forward alone)."""
    _keep_all(monkeypatch)
    params = _dec_params(**extra)
    jdec, variables, jin, dec, tin = _decoders(params, "train")
    jloss = jax_losses.Text2SpeechLoss({}, None)

    def objective(v, p):
        out, new = jdec.apply({**v, "params": p}, jin, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        loss = jloss.compute_loss({"decoder_output": out,
                                   "target_tensors": jin["target_tensors"]})
        return loss, (out, new)

    @jax.jit
    def jax_run(v):
        if not grads:
            loss, (out, new) = objective(v, v["params"])
            return loss, out, new["batch_stats"], None
        (loss, (out, new)), g = jax.value_and_grad(
            lambda p: objective(v, p), has_aux=True)(v["params"])
        return loss, out, new["batch_stats"], g

    want_loss, want, want_stats, want_grads = jax.device_get(
        jax_run(variables))
    got = dec(tin, True, torch.Generator())
    loss = losses.Text2SpeechLoss({}, None).compute_loss(
        {"decoder_output": got, "target_tensors": tin["target_tensors"]})
    assert got["decoder_spec"].shape == (B, T, F)
    _assert_outputs_close(got, want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_tree_close(_stats(dec), want_stats, "stats")
    if grads:
        loss.backward()
        _assert_grads_close(_grads(dec), want_grads)


def test_decoder_eval_zoneout_blend_matches_jax(monkeypatch):
    """Outside training zoneout is the blend p prev + (1 - p) new."""
    _keep_all(monkeypatch)
    params = _dec_params(zoneout_prob=0.3)
    jdec, variables, jin, dec, tin = _decoders(params, "eval", seed=8)
    want = jax.jit(lambda v: jdec.apply(
        v, jin, train=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables)
    with torch.no_grad():
        _assert_outputs_close(dec(tin, False, torch.Generator()), want)


def test_decoder_infer_matches_jax(monkeypatch):
    """12 free-running steps, zoneout blended: the frames, stop logits,
    alignments and the lengths from the first stop."""
    _keep_all(monkeypatch)
    params = _dec_params(zoneout_prob=0.1)
    jdec, variables, jin, dec, tin = _decoders(params, "infer", seed=9)
    variables["params"]["stop_b"][:] = 0.0
    dec.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        logits = dec(tin, False, torch.Generator())["stop_token_logits"]
    variables["params"]["stop_b"][:] = _stop_bias(logits.numpy())
    dec.load_state_dict(state_dict_from_flax(variables))
    want = jax.jit(lambda v: jdec.apply(
        v, jin, train=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables)
    with torch.no_grad():
        got = dec(tin, False, torch.Generator())
    assert got["decoder_spec"].shape == (B, 12, F)
    lengths = got["lengths"].numpy()
    assert lengths.min() >= 1 and len(set(lengths.tolist())) > 1, lengths
    _assert_outputs_close(got, want)


@pytest.mark.parametrize("kw", [{}, {"l1_norm": True, "use_mask": False,
                                     "stop_token_weight": 0.5}],
                         ids=["l2", "l1-unmasked"])
def test_loss_matches_jax(kw):
    rng = np.random.RandomState(10)
    out = {"decoder_spec": rng.randn(B, T, F).astype(np.float32),
           "post_net_spec": rng.randn(B, T, F).astype(np.float32),
           "stop_token_logits": 5 * rng.randn(B, T).astype(np.float32)}
    _, targets = _dec_inputs()
    want = jax_losses.Text2SpeechLoss(dict(kw), None).compute_loss(
        {"decoder_output": {k: jnp.asarray(v) for k, v in out.items()},
         "target_tensors": [jnp.asarray(t) for t in targets]})
    got = losses.Text2SpeechLoss(dict(kw), None).compute_loss(
        {"decoder_output": {k: torch.from_numpy(v) for k, v in out.items()},
         "target_tensors": [torch.from_numpy(t) for t in targets]})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
def _tiny_params(**overrides):
    """The tiny config with its dropout and zoneout off and Adam's
    epsilon 1e-5 (its default 1e-8 amplifies a gradient's fp32 rounding
    error where the gradient is near epsilon: see
    ``test_torch_lm_train.py``)."""
    params = copy.deepcopy(runpy.run_path(TINY)["base_params"])
    params.update(overrides)
    params["optimizer_params"]["epsilon"] = 1e-5
    params["encoder_params"].update(cnn_dropout_prob=0.0,
                                    rnn_dropout_prob=0.0)
    params["decoder_params"]["zoneout_prob"] = 0.0
    return params


def _jax_params(params):
    return dict(params, fused_rnn=False,
                encoder=jax_encoders.Tacotron2Encoder,
                decoder=jax_decoders.Tacotron2Decoder,
                loss=jax_losses.Text2SpeechLoss,
                data_layer=JaxSyntheticTTS)


def test_train_steps_match_jax(monkeypatch):
    """Two Adam + clipping steps on each side from the same weights and
    batch, the JAX side its optimizer chain on ``jax.grad`` of its
    model's loss, the biases of ``PRE_NORM_BIAS`` frozen on both sides
    (``freeze_variables_regex``: Adam would scale their noise to full-size
    updates); the losses, then the weights and batch statistics after
    each step, leaf by leaf; each step also from the JAX side's carried
    state (weights, statistics and Adam's moments)."""
    _keep_all(monkeypatch)
    from openseq2seq_tpu_torch.models import Text2SpeechTacotron
    params = _tiny_params(max_steps=2, freeze_variables_regex=PRE_NORM_BIAS)
    model = Text2SpeechTacotron(params, mode="train", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    jmodel = jax_models.Text2SpeechTacotron(_jax_params(params),
                                            mode="train")
    variables = _perturbed_weights(state.module, seed=11)
    names = [n for n, _ in state.module.named_parameters()]
    state.opt_state = model.optimizer().init(
        list(state.module.parameters()))
    tx = jmodel.optimizer()

    @jax.jit
    def jax_step(p, stats, opt):
        (loss, (_, new)), g = jax.value_and_grad(
            lambda q: jmodel.loss_fn(q, {"batch_stats": stats}, batch,
                                     jax.random.PRNGKey(0)), has_aux=True)(p)
        updates, opt = tx.update(g, opt, p)
        updates = jax.tree_util.tree_map_with_path(
            lambda path, u: jnp.zeros_like(u) if re.search(
                PRE_NORM_BIAS, "/" + "/".join(k.key for k in path)) else u,
            updates)
        return loss, optax.apply_updates(p, updates), new["batch_stats"], opt

    jstates = [(variables["params"], variables["batch_stats"],
                tx.init(variables["params"]))]
    jlosses = []
    for _ in range(2):
        loss, *carried = jax.device_get(jax_step(*jstates[-1]))
        jlosses.append(float(loss))
        jstates.append(tuple(carried))
    losses_ = []
    for i in range(2):
        state, metrics = model.train_step(state, batch, torch.Generator())
        losses_.append(float(metrics["loss"]))
        got = flax_from_state_dict(state.module.state_dict())
        _assert_tree_close(got["params"], jstates[i + 1][0],
                           "step {}".format(i + 1))
        _assert_tree_close(got["batch_stats"], jstates[i + 1][1],
                           "stats {}".format(i + 1))
    np.testing.assert_allclose(losses_, jlosses, rtol=RTOL, atol=ATOL)
    assert losses_[-1] < losses_[0]
    # the last step again, from the JAX side's carried state
    state.module.load_state_dict(state_dict_from_flax(
        {"params": jstates[1][0], "batch_stats": jstates[1][1]}))
    state.opt_state = optimizer_state_from_optax(jstates[1][2], names)
    state.step = 1
    state, metrics = model.train_step(state, batch, torch.Generator())
    np.testing.assert_allclose(float(metrics["loss"]), jlosses[1],
                               rtol=RTOL, atol=ATOL)
    _assert_tree_close(flax_from_state_dict(state.module.state_dict())[
        "params"], jstates[2][0], "from the JAX state")


def _jax_shapes(params, mode="train"):
    jmodel = jax_models.Text2SpeechTacotron(_jax_params(params), mode=mode)
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    if mode == "infer":
        batch.pop("target_tensors")
    return jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        batch, train=False))


@pytest.mark.parametrize("extra", [
    {"encoder_params": {"style_embedding_enable": True,
                        "style_embedding_params": GST}},
    {"decoder_params": {"attention_type": "bahdanau", "decoder_layers": 2,
                        "outputs_per_step": 3, "prenet_layers": 2}}],
    ids=["gst", "bahdanau-r3"])
def test_convert_round_trip(extra):
    """The port's tree through ``flax_from_state_dict`` has the JAX
    model's paths and shapes, and comes back bit for bit."""
    from openseq2seq_tpu_torch.models import Text2SpeechTacotron
    params = _tiny_params()
    for key, value in extra.items():
        params[key].update(value)
    model = Text2SpeechTacotron(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    sd = model.init_state(batch).module.state_dict()
    tree = flax_from_state_dict(sd)
    shapes = _jax_shapes(params)
    for col in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, tree[col]) == \
            jax.tree_util.tree_map(lambda x: x.shape, dict(shapes[col]))
    back = state_dict_from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_full_width_parameter_counts():
    """Tacotron-2 and its GST variant at the recipes' width: the port's
    parameter count is the JAX model's (by ``jax.eval_shape`` of its
    init), and ``chip_smoke.py`` holds the same numbers."""
    import chip_smoke
    from openseq2seq_tpu_torch.models import Text2Speech
    for name, want in (("tacotron2_synthetic.py", chip_smoke.TACOTRON_PARAMS),
                       ("tacotron_gst_synthetic.py", chip_smoke.GST_PARAMS)):
        params = copy.deepcopy(runpy.run_path(os.path.join(
            CONFIGS, name))["base_params"])
        params["data_layer_params"]["num_batches"] = 1
        params["max_steps"] = 1
        shapes = _jax_shapes(params)["params"]
        count = sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes))
        model = Text2Speech(params, mode="eval", device="cpu")
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        module = model.build_module(batch, torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in module.parameters()) == count == want


def test_c24_gst_infer_without_style():
    """The JAX GST model in infer from text alone leaves the style out:
    its encoder outputs narrow, and the decoder built on them has other
    shapes than the trained one's (a trained checkpoint cannot load). The
    port refuses that forward pass."""
    params = _tiny_params()
    params["encoder_params"].update(style_embedding_enable=True,
                                    style_embedding_params=GST)
    trained = _jax_shapes(params)["params"]
    infer = _jax_shapes(params, "infer")["params"]
    assert "gst" not in infer["enc"] and "gst" in trained["enc"]
    assert infer["dec"]["memory"]["kernel"].shape[0] == \
        trained["dec"]["memory"]["kernel"].shape[0] - GST["num_units"]
    from openseq2seq_tpu_torch.models import Text2SpeechTacotron
    model = Text2SpeechTacotron(params, mode="infer", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    assert model.eval_step(state, batch)["outputs"]["decoder_output"][
        "lengths"].min() >= 1
    batch.pop("target_tensors")
    with pytest.raises(ValueError, match="C24"):
        model.eval_step(state, batch)


def _main(*argv):
    return run.main(["--config_file=" + TINY, "--device=cpu", *argv])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_evaluates_infers(tmp_path, capsys):
    """6 steps with a checkpoint at 5 (losses finite, falling), eval from
    the checkpoint ("Validation loss" with the attention's sharpness),
    infer (one wav a row, listed in the output file); on the CPU no
    kernel launches."""
    logdir = str(tmp_path / "logs")
    launches = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
    result = _main("--logdir=" + logdir, "--mode=train", "--max_steps=6")
    assert result["steps"] == 6
    losses_ = _losses(capsys.readouterr().out)
    assert len(losses_) == 6 and all(np.isfinite(losses_))
    assert np.mean(losses_[-2:]) < np.mean(losses_[:2]), losses_
    metrics = _main("--logdir=" + logdir, "--mode=eval")
    assert re.search(r"Validation loss: [0-9.]+ \(attention sharpness "
                     r"[0-9.]+\)", capsys.readouterr().out)
    assert np.isfinite(metrics["eval_loss"])
    wav, sr = metrics["audio/synthesized"]
    assert sr == 22050 and np.isfinite(wav).all()
    out = str(tmp_path / "infer" / "infer.csv")
    _main("--logdir=" + logdir, "--mode=infer", "--infer_output_file=" + out)
    with open(out) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    assert [int(r[0]) for r in rows] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(os.path.getsize(r[1]) > 44 for r in rows)
    assert (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES) == launches


@pytest.mark.slow
def test_toy_reaches_loss_bar(tmp_path, monkeypatch, capsys):
    """``tacotron_toy.py`` from its tone wavs through ``run.main
    --mode=train_eval`` for the JAX package's 400 steps: the loss below
    its bar of 12.0 (``tests/test_text2speech.py``); then eval and infer
    (a wav a toy sentence) from the checkpoint."""
    monkeypatch.setenv("OS2S_TOY_TTS_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OS2S_TOY_LOGDIR", str(tmp_path / "logs"))
    argv = ["--config_file=" + TOY, "--device=cpu"]
    run.main(argv + ["--mode=train_eval", "--num_epochs=400"])
    losses_ = _losses(capsys.readouterr().out)
    assert losses_[-1] < 12.0, losses_
    assert np.isfinite(run.main(argv + ["--mode=eval"])["eval_loss"])
    out = str(tmp_path / "infer.csv")
    run.main(argv + ["--mode=infer", "--infer_output_file=" + out])
    with open(out) as f:
        assert len(f.read().splitlines()) == 10


def test_scan_faults_cover_the_ragged_second_tile():
    """The card checks of the scan kernels at the Tacotron shapes' 48 rows
    (a full tile of 32 and a ragged one of 16): the faults past the first
    tile are asked for, the second tile's rows from the first tile's
    first 16 and the second tile's rows zeroed alone, and read above 1,
    forward and backward, while the bf16 plain versions read at most 1;
    at 32 rows neither is asked for."""
    from openseq2seq_tpu_torch.ops import bounds as eb
    from openseq2seq_tpu_torch.ops import rnn_scan
    from openseq2seq_tpu_torch.ops import scan_bounds as sb
    from test_torch_scan_bounds import _scan_case, _scan_run
    assert sb._tiles(48) == (slice(32, 48), slice(0, 16))
    assert sb._tiles(64) == (slice(32, 64), slice(0, 32))
    assert sb._tiles(32) is None
    U = rnn_scan.units_per_cta(128)
    names = {"rows from another tile", "second tile zeroed"}
    for cell in ("lstm", "gru"):
        c = _scan_case(cell, 23, B=48, T=3)
        (outs, bounds, kw), (bouts, bbounds, bkw) = _scan_run(cell, c, True)
        assert max(eb.readings(outs, bounds).values()) <= 1.0
        assert max(eb.readings(bouts, bbounds).values()) <= 1.0
        bad = sb.cross_tile(cell, 1, slice(32, 48), slice(0, 16), **kw)
        changed = (bad != outs["ys"]).any(-1)
        assert changed[32:, 1].any() and not changed[:32].any()
        faults = sb.fwd_faults(cell, 1, slice(U, 2 * U), **kw)
        bfaults = sb.bwd_faults(cell, 1, slice(U, 2 * U), bouts["dx"], **bkw)
        assert names <= set(faults) and names <= set(bfaults)
        assert min(faults.values()) > 1.0, faults
        assert min(bfaults.values()) > 1.0, bfaults
        c = _scan_case(cell, 24, B=32, T=3)
        (_, _, kw), _ = _scan_run(cell, c, False)
        assert not names & set(sb.fwd_faults(cell, 1, slice(U, 2 * U),
                                             **kw))


def test_profile_arguments():
    """``scripts_torch/profile_eval.py --train-tacotron`` and
    ``--infer-tacotron`` profile Tacotron-2's full-width config."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
    import profile_eval
    for flag, train, infer in (("--train-tacotron", True, False),
                               ("--infer-tacotron", False, True)):
        args = profile_eval.parse_args([flag])
        assert args.config_file == os.path.join(CONFIGS,
                                                "tacotron2_synthetic.py")
        assert (args.train, args.infer) == (train, infer)
    with pytest.raises(SystemExit):
        profile_eval.parse_args(["--train-tacotron", "--infer"])
