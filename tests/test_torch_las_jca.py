"""The port's LAS and JCA family against the JAX package's, on the same
inputs and converted weights (the oracle is ``tests/test_las_jca.py``):

  * the LAS encoder, in eval and in training (batch statistics), with an
    odd length before the pyramid's pooling and ragged lengths, on the
    scan; and with ``fused_rnn`` on, where the JAX side runs its Pallas
    LSTM kernel in interpret mode and the port the plain version of
    kernel B3;
  * the LAS decoder's teacher-forced logits, alignments and the gradient
    of every parameter and of the memory: ``chorowski`` with and without
    coverage, ``bahdanau`` (spelled ``bahadanu``), ``zhaopeng``, one and
    two heads, positional tables, LSTM and GRU cells, and dropout on, the
    masks the JAX module draws replaced by fixed ones on both sides;
  * beam-2 and beam-3 decoded ids, lengths and scores;
  * the joint CTC-attention loss and its gradients, an infeasible CTC row
    among them;
  * one Speech2Text training step of the LAS and JCA test configs (the
    oracle's ``_las_config`` and ``_las_jca_config``, dropout off): the
    loss, every gradient, and the weights and batch statistics after the
    step;
  * ``convert.py``'s round trip through both models' trees;
  * C28: the JCA loss's ``ctc_loss_params`` and ``seq_loss_params`` and
    the LAS decoder's ``use_language_model`` have no effect, and the
    decode stops at min(S + 10, 1024) steps, as in the JAX package;
  * C29: padding labels outside the vocabulary past each CTC label length
    are never read, by the plain CTC either;
  * the new recipes build through the port's schema, and the tiny LAS
    and JCA recipes train, evaluate and infer through ``run.main``;
  * (slow) the LAS toy to a training loss below 0.5, the oracle's bar,
    after 200 epochs (see the test).

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on outputs, logits and losses;
gradients rtol 1e-5 and atol 1e-6 (the decoder) and the train steps'
gradients and weights rtol 1e-4, atol 1e-6, as
``test_torch_jasper_train.py``.
"""
import copy
import itertools
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu import decoders as jax_decoders
from openseq2seq_tpu import encoders as jax_encoders
from openseq2seq_tpu import losses as jax_losses
from openseq2seq_tpu.data.speech2text import \
    Speech2TextDataLayer as JaxSpeechLayer
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.ops import lstm_pallas
from openseq2seq_tpu.parts.rnns import rnn as jax_rnn
from openseq2seq_tpu.test_utils.test_speech_configs import \
    w2l_test_config as jax_w2l_test_config
from openseq2seq_tpu_torch import decoders, encoders, losses, run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.decoders.las_decoder import LASDecoderModule
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.models.model import to_device_batch
from openseq2seq_tpu_torch.ops import ctc, lstm_scan
from openseq2seq_tpu_torch.parts.rnns.rnn import GRU, LSTM
from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
    w2l_test_config
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_jasper_train import FREEZE, _assert_tree_close
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(REPO, "example_configs_torch", "speech2text")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _perturbed(module, seed, scale=0.05):
    """The port module's weights (and batch statistics) moved by N(0,
    scale^2), loaded back into it and returned as flax variables."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(
        lambda v: (v + scale * rng.randn(*v.shape)).astype(np.float32),
        flax_from_state_dict(module.state_dict()))
    module.load_state_dict(state_dict_from_flax(tree))
    return {k: v for k, v in tree.items() if v}


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def _enc_params(fused):
    units = 128 if fused else 24
    return {"convnet_layers": [
        {"type": "conv1d", "repeat": 1, "kernel_size": [5], "stride": [2],
         "num_channels": 24, "padding": "SAME"}],
        "recurrent_layers": [
            {"type": "lstm", "num_units": units, "pool": 2},
            {"type": "lstm", "num_units": units}] + ([] if fused else [
            {"type": "gru", "num_units": 16, "pool": 2,
             "unidirectional": True}]),
        "activation_fn": "relu", "dropout_keep_prob": 1.0}


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_las_encoder_matches_jax(fused):
    """T 37 -> 19 frames after the stride-2 conv (odd before the pooling)
    -> 9 -> 4; lengths 37, 30, 5, 1 (pooled to at least 1)."""
    B = 8 if fused else 4
    rng = np.random.RandomState(0)
    x = rng.randn(B, 37, 16).astype(np.float32)
    lens = np.array([37, 30, 5, 1, 37, 20, 11, 2][:B], np.int32)
    params = _enc_params(fused)
    enc = encoders.ListenAttendSpellEncoder(params, None).make_module(
        16, torch.Generator().manual_seed(0))
    for m in enc.modules():
        if isinstance(m, (LSTM, GRU)):
            m.fused = fused
    variables = _perturbed(enc, 1)
    jenc = jax_encoders.ListenAttendSpellEncoder(params, None).make_module()
    inputs = {"source_tensors": [jnp.asarray(x), jnp.asarray(lens)]}
    tin = {"source_tensors": [torch.from_numpy(x), torch.from_numpy(lens)]}
    if fused:
        jax_rnn._FUSED_RNN = True
        lstm_pallas.FORCE_INTERPRET = True
    want = jax.jit(lambda v, i: jenc.apply(v, i, train=False))(variables,
                                                               inputs)
    calls = []
    fn = lstm_scan.lstm_scan
    lstm_scan.lstm_scan = lambda *a, **k: calls.append(1) or fn(*a, **k)
    try:
        with torch.no_grad():
            got = enc(tin, False)
    finally:
        lstm_scan.lstm_scan = fn
    assert len(calls) == (4 if fused else 0)
    assert got["outputs"].shape == want["outputs"].shape
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  np.asarray(want["src_length"]))
    assert got["src_length"].tolist() == ([9, 7, 1, 1, 9, 5, 3, 1]
                                          if fused else [4, 3, 1, 1])
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), **TOL)
    if fused:
        return
    # training: batch statistics, and their update
    want, new_stats = jax.jit(lambda v, i: jenc.apply(
        v, i, train=True, mutable=["batch_stats"]))(variables, inputs)
    with torch.no_grad():
        got = enc(tin, True, torch.Generator())
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), **TOL)
    _assert_tree_close(flax_from_state_dict(enc.state_dict())["batch_stats"],
                       jax.device_get(new_stats["batch_stats"]))


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

B, S, E, T, V = 3, 11, 24, 7, 12
MEM_LEN = np.array([11, 6, 3], np.int32)


def _dec_params(**extra):
    attention = extra.pop("attention", {})
    p = {"GO_SYMBOL": 9, "END_SYMBOL": 10, "tgt_vocab_size": V,
         "tgt_emb_size": 16, "rnn_type": "lstm", "hidden_dim": 16,
         "num_layers": 1, "dropout_keep_prob": 1.0,
         "attention_params": dict({"attention_dim": 20,
                                   "attention_type": "chorowski",
                                   "use_coverage": False, "num_heads": 1,
                                   "plot_attention": True}, **attention)}
    p.update(extra)
    return p


def _dec_inputs():
    rng = np.random.RandomState(2)
    memory = rng.randn(B, S, E).astype(np.float32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)
    y[:, 0] = 9
    return memory, y, np.array([7, 5, 3], np.int32)


def _decoders(params, mode, seed=4):
    """(JAX module, its variables, port module on them)."""
    jdec = jax_decoders.ListenAttendSpellDecoder(params, None,
                                                 mode=mode).make_module()
    dec = decoders.ListenAttendSpellDecoder(params, None, mode=mode) \
        .make_module(E, torch.Generator().manual_seed(0))
    return jdec, _perturbed(dec, seed), dec


DEC_CASES = {
    # no coverage, two heads, two LSTM layers, the positional tables, and
    # dropout on
    "chorowski_two_heads_dropout": dict(attention={"num_heads": 2},
                                        num_layers=2, pos_embedding=True,
                                        dropout_keep_prob=0.7),
    "zhaopeng_coverage_gru": dict(attention={"attention_type": "zhaopeng",
                                             "use_coverage": True},
                                  rnn_type="gru"),
    "bahdanau_gru_two_layers": dict(attention={"attention_type": "bahadanu"},
                                    rnn_type="gru", num_layers=2),
}


def _fixed_masks(params, monkeypatch):
    """Dropout on: the masks of the JAX module's ``jax.random.bernoulli``
    calls (layer i, then the projection, once per traced step) and of the
    port's ``keep_mask`` (by site) replaced by the same fixed masks."""
    L, H = params["num_layers"], params["hidden_dim"]
    NH = params["attention_params"]["num_heads"]
    rng = np.random.RandomState(8)
    keep = params["dropout_keep_prob"]
    masks = [rng.rand(B, H) < keep for _ in range(L)] + \
        [rng.rand(B, NH * H) < keep]
    counter = itertools.count()
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(masks[next(counter) % (L + 1)]))
    monkeypatch.setattr(
        LASDecoderModule, "keep_mask", lambda self, shape, site, gen, dev:
        torch.from_numpy(masks[site]).reshape(
            (B,) + (1,) * (len(shape) - 2) + masks[site].shape[1:])
        .expand(shape))


@pytest.mark.parametrize("case", sorted(DEC_CASES))
def test_las_decoder_matches_jax(case, monkeypatch):
    """Teacher-forced logits and head 0's alignments, and the gradients of
    sum(logits W) + sum(alignments W') for every parameter and the
    memory."""
    params = _dec_params(**copy.deepcopy(DEC_CASES[case]))
    if params["dropout_keep_prob"] < 1.0:
        _fixed_masks(params, monkeypatch)
    jdec, variables, dec = _decoders(params, "train")
    memory, y, y_len = _dec_inputs()
    rng = np.random.RandomState(6)
    wl = rng.randn(B, T - 1, V).astype(np.float32)
    wa = rng.randn(B, T - 1, S).astype(np.float32)

    def jloss(p, mem):
        out = jdec.apply({"params": p}, {
            "encoder_output": {"outputs": mem,
                               "src_length": jnp.asarray(MEM_LEN)},
            "target_tensors": [jnp.asarray(y), jnp.asarray(y_len)]},
            train=True, rngs={"dropout": jax.random.PRNGKey(5)})
        return (jnp.sum(out["logits"] * wl) +
                jnp.sum(out["alignments"] * wa)), out

    (_, want), (jgrads, jgrad_mem) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"],
                                              jnp.asarray(memory))
    mem = torch.from_numpy(memory).requires_grad_()
    got = dec({"encoder_output": {"outputs": mem,
                                  "src_length": torch.from_numpy(MEM_LEN)},
               "target_tensors": [torch.from_numpy(y),
                                  torch.from_numpy(y_len)]}, True,
              torch.Generator())
    assert got["logits"].shape == (B, T - 1, V)
    assert got["alignments"].shape == (B, T - 1, S)
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(got["alignments"].detach().numpy(),
                               np.asarray(want["alignments"]), **TOL)
    ((got["logits"] * torch.from_numpy(wl)).sum() +
     (got["alignments"] * torch.from_numpy(wa)).sum()).backward()
    grads = flax_from_state_dict({n: p.grad for n, p in
                                  dec.named_parameters()})["params"]
    jgrads = jax.device_get(jgrads)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, w, err_msg=str(path), **GRAD_TOL)
    np.testing.assert_allclose(mem.grad.numpy(), np.asarray(jgrad_mem),
                               **GRAD_TOL)


@pytest.mark.parametrize("beam", [2, 3])
def test_las_beam_decode_matches_jax(beam):
    params = _dec_params(attention={"use_coverage": True, "num_heads": 2},
                         pos_embedding=True, beam_width=beam)
    jdec, variables, dec = _decoders(params, "infer", seed=7)
    memory, y, y_len = _dec_inputs()
    enc_out = {"outputs": memory, "src_length": MEM_LEN}
    want = jax.jit(lambda v, e: jdec.apply(v, {"encoder_output": e},
                                           train=False))(
        variables, jax.tree_util.tree_map(jnp.asarray, enc_out))
    with torch.no_grad():
        got = dec({"encoder_output": {k: torch.from_numpy(v) for k, v in
                                      enc_out.items()},
                   "target_tensors": [torch.from_numpy(y),
                                      torch.from_numpy(y_len)]}, False)
    assert "logits" not in got            # infer: no teacher forcing
    ids, lengths = got["outputs"]
    assert ids.shape == (B, S + 10)       # C28: the decode cap
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want["outputs"][0]))
    np.testing.assert_array_equal(lengths.numpy(),
                                  np.asarray(want["outputs"][1]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)


# ---------------------------------------------------------------------------
# the joint CTC-attention loss
# ---------------------------------------------------------------------------

def _jca_inputs():
    """CTC logits (B, 9, V - 1) and attention logits (B, 6, V) over
    targets <S> x.. </S> padded with </S>; row 2's 5 characters do not
    fit its 3 CTC frames (infeasible)."""
    rng = np.random.RandomState(3)
    Bj, Vj = 4, 8
    labels = np.full((Bj, 7), 7, np.int32)
    label_lens = np.array([7, 4, 7, 2], np.int32)
    for b, n in enumerate(label_lens):
        labels[b, 0] = 6
        labels[b, 1:n - 1] = rng.randint(0, 6, n - 2)
    ctc_logits = rng.randn(Bj, 9, Vj - 1).astype(np.float32)
    src_len = np.array([9, 7, 3, 5], np.int32)
    seq_logits = rng.randn(Bj, 6, Vj).astype(np.float32)
    return ctc_logits, src_len, seq_logits, labels, label_lens


def _jca_loss_params(**extra):
    return dict({"ctc_loss_params": {}, "seq_loss_params": {},
                 "lambda_value": 0.3, "tgt_vocab_size": 8, "batch_size": 4},
                **extra)


def test_jca_loss_and_gradients_match_jax():
    ctc_logits, src_len, seq_logits, labels, label_lens = _jca_inputs()
    assert not bool(ctc.feasible_rows(
        torch.from_numpy(src_len), torch.from_numpy(labels[:, 1:]),
        torch.from_numpy(label_lens - 2))[2])
    jl = jax_losses.MultiTaskCTCEntropyLoss(_jca_loss_params(), None)

    def jloss(c, s):
        return jl.compute_loss({"decoder_output": {
            "ctc_outputs": {"logits": c, "src_length": jnp.asarray(src_len)},
            "seq_outputs": {"logits": s}},
            "target_tensors": [jnp.asarray(labels), jnp.asarray(label_lens)]})

    want, (jgc, jgs) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(ctc_logits), jnp.asarray(seq_logits))
    c = torch.from_numpy(ctc_logits).requires_grad_()
    s = torch.from_numpy(seq_logits).requires_grad_()
    loss = losses.MultiTaskCTCEntropyLoss(_jca_loss_params(), None) \
        .compute_loss({"decoder_output": {
            "ctc_outputs": {"logits": c,
                            "src_length": torch.from_numpy(src_len)},
            "seq_outputs": {"logits": s}},
            "target_tensors": [torch.from_numpy(labels),
                               torch.from_numpy(label_lens)]})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), **GRAD_TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgs), **GRAD_TOL)
    assert not c.grad[2].any()            # the infeasible row: no gradient


def test_c29_padding_labels_past_the_length():
    """The JAX CTC ignores what pads each label row past its length, even
    ids outside the vocabulary (its gathers clamp); the port's plain CTC
    used to index the vocabulary with them and raise. Labels padded with
    the end symbol (id 7 of a 7-class CTC head, as the JCA loss passes
    them, and as ``test_jca_loss_and_gradients_match_jax`` holds against
    the JAX loss) now give the loss and gradient of zero padding, bit for
    bit."""
    ctc_logits, src_len, _, labels, label_lens = _jca_inputs()
    lab, n = labels[:, 1:], label_lens - 2
    assert lab.max() == 7 and ctc_logits.shape[-1] == 7
    zero = np.where(np.arange(6)[None, :] < n[:, None], lab, 0)
    got = []
    for pad in (lab, zero):
        x = torch.from_numpy(ctc_logits).requires_grad_()
        loss = ctc.ctc_loss(x, torch.from_numpy(src_len),
                            torch.from_numpy(np.ascontiguousarray(pad)),
                            torch.from_numpy(n))
        loss.backward()
        got.append((float(loss.detach()), x.grad))
    assert got[0][0] == got[1][0]
    assert torch.equal(got[0][1], got[1][1])


def test_c28_loss_keys_and_language_model_key_without_effect():
    """C28: the JCA loss ignores ``ctc_loss_params`` and
    ``seq_loss_params``, as the JAX loss does; the LAS decoder accepts
    ``use_language_model`` with no effect."""
    ctc_logits, src_len, seq_logits, labels, label_lens = _jca_inputs()
    inputs = {"decoder_output": {
        "ctc_outputs": {"logits": torch.from_numpy(ctc_logits),
                        "src_length": torch.from_numpy(src_len)},
        "seq_outputs": {"logits": torch.from_numpy(seq_logits)}},
        "target_tensors": [torch.from_numpy(labels),
                           torch.from_numpy(label_lens)]}
    values = {float(losses.MultiTaskCTCEntropyLoss(
        _jca_loss_params(**extra), None).compute_loss(inputs))
        for extra in ({}, {"ctc_loss_params": {"mask_nan": False}},
                      {"seq_loss_params": {"offset_target_by_one": False,
                                           "average_across_timestep": False}})}
    assert len(values) == 1
    a = decoders.ListenAttendSpellDecoder(_dec_params(), None).make_module(
        E, torch.Generator().manual_seed(0))
    b = decoders.ListenAttendSpellDecoder(
        _dec_params(use_language_model=True), None).make_module(
        E, torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _las_setup(params, toy):
    """The oracle's ``_las_config`` on ``params`` (a w2l_test_config)."""
    params["data_layer_params"]["autoregressive"] = True
    params["encoder_params"] = {
        "convnet_layers": [{"type": "conv1d", "repeat": 1,
                            "kernel_size": [7], "stride": [2],
                            "num_channels": 48, "padding": "SAME"}],
        "recurrent_layers": [{"type": "lstm", "num_units": 48, "pool": 2}],
        "activation_fn": "relu", "dropout_keep_prob": 1.0}
    params["decoder_params"] = {
        "GO_SYMBOL": 9, "END_SYMBOL": 10, "tgt_emb_size": 48,
        "attention_params": {"attention_dim": 48,
                             "attention_type": "chorowski",
                             "use_coverage": False, "num_heads": 2,
                             "plot_attention": True},
        "rnn_type": "lstm", "hidden_dim": 48, "num_layers": 1,
        "pos_embedding": True, "dropout_keep_prob": 1.0, "beam_width": 2}
    params["loss_params"] = {}
    params["optimizer_params"] = {"learning_rate": 1e-3}
    return params


def _jca_setup(params, toy):
    """The oracle's ``_las_jca_config``, dropout off."""
    params["data_layer_params"]["autoregressive"] = True
    params["encoder_params"] = {
        "convnet_layers": [{"type": "conv1d", "repeat": 1,
                            "kernel_size": [7], "stride": [2],
                            "num_channels": 32, "padding": "SAME"}],
        "recurrent_layers": [{"type": "lstm", "num_units": 32, "pool": 2},
                             {"type": "lstm", "num_units": 32}],
        "activation_fn": "relu", "dropout_keep_prob": 1.0}
    params["decoder_params"] = {
        "ctc_decoder_params": {"use_language_model": False},
        "attn_decoder_params": {
            "tgt_emb_size": 32,
            "attention_params": {"attention_dim": 32,
                                 "attention_type": "chorowski",
                                 "use_coverage": True, "num_heads": 1,
                                 "plot_attention": False},
            "rnn_type": "lstm", "hidden_dim": 32, "num_layers": 1,
            "dropout_keep_prob": 1.0},
        "beam_search_params": {"beam_width": 2},
        "language_model_params": {}, "GO_SYMBOL": 9, "END_SYMBOL": 10}
    params["loss_params"] = {"ctc_loss_params": {}, "seq_loss_params": {},
                             "lambda_value": 0.5}
    return params


def _model_pair(kind, toy, mode="train"):
    """(port model, JAX model) of the oracle's config ``kind``, Adam's
    epsilon 1e-5 (its default 1e-8 amplifies a gradient's fp32 rounding
    error where the gradient is near epsilon: see
    ``test_torch_lm_train.py``) and the biases of the convs that feed a
    batch norm frozen (the norm removes them, so their gradient is
    rounding noise: see ``test_torch_jasper_train.py``)."""
    setup = _las_setup if kind == "las" else _jca_setup
    port = setup(w2l_test_config(toy["csv"], toy["vocab"],
                                 num_epochs=1)[0], toy)
    jp = setup(jax_w2l_test_config(toy["csv"], toy["vocab"],
                                   num_epochs=1)[0], toy)
    for p in (port, jp):
        p["optimizer_params"] = dict(p["optimizer_params"], epsilon=1e-5)
        p["freeze_variables_regex"] = FREEZE
    if kind == "las":
        port.update(encoder=encoders.ListenAttendSpellEncoder,
                    decoder=decoders.ListenAttendSpellDecoder,
                    loss=losses.BasicSequenceLoss)
        jp.update(encoder=jax_encoders.ListenAttendSpellEncoder,
                  decoder=jax_decoders.ListenAttendSpellDecoder,
                  loss=jax_losses.BasicSequenceLoss)
    else:
        port.update(encoder=encoders.ListenAttendSpellEncoder,
                    decoder=decoders.JointCTCAttentionDecoder,
                    loss=losses.MultiTaskCTCEntropyLoss)
        port["decoder_params"].update(
            ctc_decoder=decoders.FullyConnectedCTCDecoder,
            attn_decoder=decoders.ListenAttendSpellDecoder)
        jp.update(encoder=jax_encoders.ListenAttendSpellEncoder,
                  decoder=jax_decoders.JointCTCAttentionDecoder,
                  loss=jax_losses.MultiTaskCTCEntropyLoss)
        jp["decoder_params"].update(
            ctc_decoder=jax_decoders.FullyConnectedCTCDecoder,
            attn_decoder=jax_decoders.ListenAttendSpellDecoder)
    jp["data_layer"] = JaxSpeechLayer
    return (Speech2Text(port, mode=mode, device="cpu"),
            JaxSpeech2Text(jp, mode=mode))


@pytest.mark.parametrize("kind", ["las", "jca"])
def test_train_step_matches_jax(kind, toy_speech_data):
    """One step from the same weights and batch statistics: the loss and
    every gradient against ``jax.grad`` of the JAX model's loss, then the
    weights and batch statistics after the JAX model's optimizer chain
    (Adam behind the config's clipping) on those gradients, in one jitted
    function."""
    import optax
    model, jmodel = _model_pair(kind, toy_speech_data)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    jbatch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    for key in ("source_tensors", "target_tensors"):
        for a, b in zip(batch[key], jbatch[key]):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
    state = model.init_state(batch)
    variables = _perturbed(state.module, 3, scale=0.02)
    tx = jmodel.optimizer()

    frozen = re.compile(FREEZE)

    @jax.jit
    def jax_step(p, stats, b):
        (loss, (_, new_state)), g = jax.value_and_grad(
            lambda q: jmodel.loss_fn(q, {"batch_stats": stats}, b,
                                     jax.random.PRNGKey(0)),
            has_aux=True)(p)
        updates, _ = tx.update(g, tx.init(p), p)
        updates = jax.tree_util.tree_map_with_path(
            lambda path, u: jnp.zeros_like(u) if frozen.search(
                "/" + "/".join(k.key for k in path)) else u, updates)
        return loss, g, optax.apply_updates(p, updates), \
            new_state["batch_stats"]

    jloss, jgrads, jparams, jstats = jax.device_get(jax_step(
        variables["params"], variables["batch_stats"],
        jax.tree_util.tree_map(np.asarray, batch)))
    module = state.module
    device_batch = to_device_batch(batch, "cpu")
    saved = copy.deepcopy(module.state_dict())
    model.compute_loss(module(device_batch, train=True,
                              generator=torch.Generator()),
                       device_batch).backward()
    grads = dict(saved)
    grads.update({n: p.grad for n, p in module.named_parameters()})
    module.zero_grad(set_to_none=True)
    module.load_state_dict(saved)
    _assert_tree_close(flax_from_state_dict(grads)["params"], jgrads,
                       "grads")
    state, metrics = model.train_step(state, batch, torch.Generator())
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), **TOL)
    got = flax_from_state_dict(state.module.state_dict())
    _assert_tree_close(got["params"], jparams)
    _assert_tree_close(got["batch_stats"], jstats)


@pytest.mark.parametrize("kind", ["las", "jca"])
def test_convert_round_trip(kind, toy_speech_data):
    """The port's tree through ``flax_from_state_dict`` has the JAX
    model's paths and shapes (from its init), and comes back bit for
    bit."""
    model, jmodel = _model_pair(kind, toy_speech_data, mode="eval")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    sd = model.init_state(batch).module.state_dict()
    tree = flax_from_state_dict(sd)
    shapes = jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    for key in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, tree[key]) == \
            jax.tree_util.tree_map(lambda x: x.shape, dict(shapes[key]))
    back = state_dict_from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# the recipes and the entry point
# ---------------------------------------------------------------------------

NEW_RECIPES = ("las_large_8gpus.py", "las_large_librispeech.py",
               "jca_large_8gpus.py", "las_toy.py", "las_tiny.py",
               "jca_tiny.py", "jasper10x5_beam_librispeech.py")


def test_recipes_build_through_the_schema(tmp_path, monkeypatch):
    """Each new recipe's model, in each of its modes, on a fake corpus of
    the LibriSpeech layout (the toys on their toy wavs); the full-width
    recipes at the widths of their JAX twins, whose keys they carry."""
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    from openseq2seq_tpu_torch.utils.config import configs_for_modes
    data = str(tmp_path / "libri")
    fake_librispeech.generate(data, n_utts=4, duration=1.0,
                              transcript_chars=12)
    for name in ("librivox-dev-clean.csv", "librivox-test-clean.csv"):
        with open(os.path.join(data, "librivox-train-clean-100.csv")) as f:
            text = f.read()
        with open(os.path.join(data, name), "w") as f:
            f.write(text)
    monkeypatch.setenv("LIBRISPEECH_DIR", data)
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    monkeypatch.setenv("CHAR_LM", str(tmp_path / "char.arpa"))
    from openseq2seq_tpu_torch.ops.ngram_fusion import build_label_lm
    build_label_lm(["the quick dog"] * 3, str(tmp_path / "char.arpa"),
                   order=3)
    for name in NEW_RECIPES:
        path = os.path.join(RECIPES, name)
        cfg = runpy.run_path(path)
        jname = os.path.join(REPO, "example_configs", "speech2text", name)
        if os.path.exists(jname):
            want = _keys(runpy.run_path(jname)["base_params"])
            assert _keys(cfg["base_params"]) == want, name
        for run_mode in ("train_eval", "infer"):
            args = type("Args", (), {"mode": run_mode})
            for mode, params in configs_for_modes(
                    args, cfg["base_params"], cfg).items():
                model = cfg["base_model"](params, mode=mode, device="cpu")
                if name == "jasper10x5_beam_librispeech.py" and \
                        mode == "infer":
                    assert model._decoder.params[
                        "on_device_beam_width"] == 16
    big = runpy.run_path(os.path.join(RECIPES, "las_large_librispeech.py"))
    assert big["base_params"]["fused_rnn"] is True


def _keys(tree, prefix=""):
    """Every key path of a nested config dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


@pytest.mark.parametrize("name", ["las_tiny.py", "jca_tiny.py"])
def test_run_main_trains_evaluates_infers(name, tmp_path, monkeypatch,
                                          capsys):
    """4 steps with a checkpoint and an eval at 4 ("Validation WER"), then
    eval and infer (one CSV row a wav) from the checkpoint; on the CPU no
    kernel launches."""
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    logdir = str(tmp_path / "logs")
    path = os.path.join(RECIPES, name)
    launches = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
    common = ["--config_file=" + path, "--device=cpu", "--logdir=" + logdir]
    run.main(common + ["--mode=train_eval", "--num_epochs=4"])
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert "Validation WER" in out
    metrics = run.main(common + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and "Eval WER" in metrics
    infer_file = str(tmp_path / "infer.csv")
    run.main(common + ["--mode=infer", "--infer_output_file=" + infer_file])
    with open(infer_file) as f:
        rows = f.read().splitlines()
    assert len(rows) == 11 and rows[0] == "wav_filename,predicted_transcript"
    assert (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES) == launches


@pytest.mark.slow
def test_las_toy_convergence(tmp_path, monkeypatch, capsys):
    """``las_toy.py`` learns its 10 utterances: the oracle's bar, the last
    loss below 0.5, after 200 epochs. The oracle asks it after 150, where
    the loss is falling fastest: from the port's seed-0 weights the CPU
    run reads 0.5928 at epoch 150 and crosses 0.5 a few epochs later
    (0.0488 at 200), the card 0.1881 at 150 (``chip_smoke.py`` 7zzb holds
    the oracle's 150); the JAX package's own weights read 0.3783 at 140.
    The two packages' steps agree from the same weights
    (``test_train_step_matches_jax``)."""
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    run.main(["--config_file=" + os.path.join(RECIPES, "las_toy.py"),
              "--device=cpu", "--logdir=" + str(tmp_path / "logs"),
              "--mode=train", "--print_loss_steps=1", "--num_epochs=200"])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 200 and losses[-1] < 0.5, losses[-5:]
