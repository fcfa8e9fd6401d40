"""The port's RNN NMT family against the JAX package's, on the same inputs
and converted weights:

  * the three encoders (unidirectional, bidirectional, GNMT-like) with
    LSTM and GRU cells, on the fused recurrence (the scan kernels' plain
    versions, at the narrow fp32 width of 64 the kernels take) and on the
    scan; the JAX side runs its scan, the same function in fp32;
  * the attention decoder's teacher-forced logits for the four attention
    types, plus ``weight_tied``, skip connections and ``sampling_prob``
    1.0 (the coin is then always 1, so the comparison is exact);
  * beam-1 and beam-4 decoded ids;
  * the tiny GNMT config (``example_configs_torch/text2text/
    en_de_gnmt_like_tiny.py``, dropout off, two decoder layers): the
    gradients of a train step against ``jax.grad`` of the JAX model's
    loss, then three Adam steps each from the JAX side's carried state;
  * the converter's round trip through the encoder's and decoder's tree;
  * C22: the JAX package's Text2Text shifts the targets and its sequence
    loss shifts them again; the port shifts them once. The JAX side of
    every parity test here therefore takes ``offset_target_by_one: False``;
  * ``run.main`` in train, eval and infer on the tiny GNMT config;
  * (slow) the RNN reversal toy to a validation BLEU above 80.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on outputs and logits; gradients
and the weights after Adam steps rtol 1e-4 and atol 1e-6, as
``test_torch_jasper_train.py``."""
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
from openseq2seq_tpu.data.text2text import \
    ParallelTextDataLayer as JaxParallelText
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu.models import Text2Text as JaxText2Text
from openseq2seq_tpu_torch import decoders, encoders, run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           optimizer_state_from_optax,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.models.model import to_device_batch
from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
from openseq2seq_tpu_torch.parts.rnns.rnn import GRU, LSTM
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_jasper_train import ATOL, RTOL, _assert_tree_close
# the tiny config's corpus in a directory of this module's own, and
# torch on one thread
from test_torch_text_data import one_thread, tiny_corpus_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2text")
TINY = os.path.join(CONFIGS, "en_de_gnmt_like_tiny.py")
RNN_TOY = os.path.join(CONFIGS, "nmt_reversal_toy_rnn.py")
B, S, T, V, H = 4, 9, 7, 14, 64
SRC_LEN = np.array([9, 4, 1, 7], np.int32)


def _leaves_perturbed(variables, seed):
    """Every leaf moved by N(0, 0.05^2), so that zero-initialized biases
    and a wrong mapping show."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, dict(variables)))


def _perturbed_weights(module, seed):
    """The port module's weights, perturbed, loaded back into it, and as
    flax variables for the JAX module (whose own init would compile its
    scans once more; ``test_convert_round_trip`` holds the two trees'
    paths and shapes equal)."""
    variables = _leaves_perturbed(flax_from_state_dict(module.state_dict()),
                                  seed)
    module.load_state_dict(state_dict_from_flax(variables))
    return {"params": variables["params"]}


def _enc_params(cell, layers):
    return {"src_vocab_size": V, "src_emb_size": 32, "core_cell": cell,
            "core_cell_params": {"num_units": H}, "encoder_layers": layers,
            "encoder_use_skip_connections": True}


def _ids(shape, seed):
    return np.random.RandomState(seed).randint(0, V, shape).astype(np.int32)


def _set_fused(module, fused):
    for m in module.modules():
        if isinstance(m, (LSTM, GRU)):
            m.fused = fused


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("layout", ["UnidirectionalRNN", "BidirectionalRNN",
                                    "GNMTLike"])
def test_encoder_matches_jax(layout, cell, monkeypatch):
    """The port on the fused recurrence and on the scan, each against the
    JAX module's output."""
    name = layout + "EncoderWithEmbedding"
    # two layers (the second's skip connection) or, for GNMT's residual
    # from the third layer on, three
    params = _enc_params(cell, 3 if layout == "GNMTLike" else 2)
    jenc = getattr(jax_encoders, name)(params, None, mode="eval") \
        .make_module()
    ids = _ids((B, S), 0)
    inputs = {"source_tensors": [jnp.asarray(ids), jnp.asarray(SRC_LEN)]}
    enc = getattr(encoders, name)(params, None, mode="eval").make_module(
        0, torch.Generator().manual_seed(0))
    variables = _perturbed_weights(enc, seed=1)
    want = np.asarray(jax.jit(lambda v, i: jenc.apply(v, i, train=False))(
        variables, inputs)["outputs"])
    calls = []
    kernel = lstm_scan if cell == "lstm" else gru_scan
    fn = getattr(kernel, cell + "_scan")
    monkeypatch.setattr(kernel, cell + "_scan",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    layers = {"UnidirectionalRNN": 2, "BidirectionalRNN": 4, "GNMTLike": 4}
    for fused in (True, False):
        _set_fused(enc, fused)
        del calls[:]
        with torch.no_grad():
            got = enc({"source_tensors": [torch.from_numpy(ids),
                                          torch.from_numpy(SRC_LEN)]}, False)
        assert len(calls) == (layers[layout] if fused else 0)
        assert got["outputs"].shape == want.shape
        np.testing.assert_allclose(got["outputs"].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg="fused {}".format(fused))


def _dec_params(attention, **extra):
    return dict({"GO_SYMBOL": 2, "END_SYMBOL": 1, "tgt_vocab_size": V,
                 "tgt_emb_size": 32, "attention_layer_size": 48,
                 "attention_type": attention, "core_cell": "lstm",
                 "core_cell_params": {"num_units": H}, "decoder_layers": 3,
                 "decoder_use_skip_connections": False, "batch_size": B},
                **extra)


def _dec_inputs(E=40):
    rng = np.random.RandomState(2)
    memory = rng.randn(B, S, E).astype(np.float32)
    y = _ids((B, T), 3)
    y[:, 0] = 2
    y_len = np.array([7, 5, 2, 6], np.int32)
    return memory, y, y_len


def _decoders(params, mode, seed=4):
    """(JAX module, its perturbed variables, port module on them)."""
    memory, y, y_len = _dec_inputs()
    jdec = jax_decoders.RNNDecoderWithAttention(params, None,
                                                mode=mode).make_module()
    inputs = {"encoder_output": {"outputs": jnp.asarray(memory),
                                 "src_length": jnp.asarray(SRC_LEN)},
              "target_tensors": [jnp.asarray(y), jnp.asarray(y_len)]}
    dec = decoders.RNNDecoderWithAttention(params, None, mode=mode) \
        .make_module(memory.shape[-1], torch.Generator().manual_seed(0))
    variables = _perturbed_weights(dec, seed)
    torch_inputs = {"encoder_output": {"outputs": torch.from_numpy(memory),
                                       "src_length": torch.from_numpy(
                                           SRC_LEN)},
                    "target_tensors": [torch.from_numpy(y),
                                       torch.from_numpy(y_len)]}
    return jdec, variables, inputs, dec, torch_inputs


@pytest.mark.parametrize("attention,extra", [
    ("bahdanau", {}), ("luong", {}), ("gnmt", {}), ("gnmt_v2", {}),
    ("gnmt_v2", {"weight_tied": True}),
    ("bahdanau", {"decoder_use_skip_connections": True}),
    ("gnmt", {"sampling_prob": 1.0}),
], ids=["bahdanau", "luong", "gnmt", "gnmt_v2", "weight_tied", "skip",
        "sampling"])
def test_decoder_logits_match_jax(attention, extra):
    params = _dec_params(attention, **extra)
    jdec, variables, inputs, dec, torch_inputs = _decoders(params, "train")
    train = "sampling_prob" in extra
    want = jax.jit(lambda v, i: jdec.apply(
        v, i, train=train, rngs={"dropout": jax.random.PRNGKey(5)}))(
            variables, inputs)
    with torch.no_grad():
        got = dec(torch_inputs, train, torch.Generator().manual_seed(5))
    assert got["logits"].shape == (B, T - 1, V)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-5)
    if "weight_tied" in extra:
        assert "out_w" not in dict(dec.named_parameters())


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_decode_matches_jax(beam):
    params = _dec_params("gnmt_v2", beam_width=beam, length_penalty=0.6)
    jdec, variables, inputs, dec, torch_inputs = _decoders(params, "infer",
                                                           seed=6)
    want = jax.jit(lambda v, i: jdec.apply(v, i, train=False))(
        variables, {"encoder_output": inputs["encoder_output"]})
    with torch.no_grad():
        got = dec({"encoder_output": torch_inputs["encoder_output"]}, False)
    ids, lengths = got["outputs"]
    assert ids.shape == (B, 2 * S + 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want["outputs"][0]))
    np.testing.assert_array_equal(lengths.numpy(),
                                  np.asarray(want["outputs"][1]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-5,
                               atol=1e-5)


def _tiny_params(**overrides):
    """The tiny GNMT config with its dropout off and Adam's epsilon 1e-5
    (its default 1e-8 amplifies a gradient's fp32 rounding error where the
    gradient is near epsilon: see ``test_torch_lm_train.py``)."""
    params = dict(runpy.run_path(TINY)["base_params"], **overrides)
    params["optimizer_params"] = dict(params["optimizer_params"],
                                      epsilon=1e-5)
    params["encoder_params"] = dict(params["encoder_params"],
                                    encoder_dp_input_keep_prob=1.0)
    params["decoder_params"] = dict(params["decoder_params"])
    return params


def _jax_params(params):
    """The port's config with the JAX package's classes; the loss without
    its second shift (C22) and the scan recurrence (the same function as
    the port's fused one in fp32)."""
    return dict(params, fused_rnn=False,
                encoder=jax_encoders.GNMTLikeEncoderWithEmbedding,
                decoder=jax_decoders.BeamSearchRNNDecoderWithAttention,
                loss=JaxSequenceLoss, data_layer=JaxParallelText,
                loss_params=dict(params["loss_params"],
                                 offset_target_by_one=False))


def test_train_steps_match_jax():
    """The gradients of one step against ``jax.grad`` of the JAX model's
    loss; then three Adam steps on each side, the JAX side's its
    optimizer chain (``jmodel.optimizer()``, with the config's clipping)
    on those gradients, as its ``train_step`` applies it in fp32; and
    each step again from the JAX side's carried weights and Adam
    state."""
    params = _tiny_params(max_steps=3)
    params["decoder_params"]["decoder_layers"] = 2
    model = Text2Text(params, mode="train", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    jmodel = JaxText2Text(_jax_params(params), mode="train")
    jbatch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    for key in ("source_tensors", "target_tensors"):
        for a, b in zip(batch[key], jbatch[key]):
            np.testing.assert_array_equal(a, b)
    jparams = _perturbed_weights(state.module, seed=7)["params"]
    tx = jmodel.optimizer()
    jopt = tx.init(jparams)

    @jax.jit
    def jax_step(p, opt):
        loss, g = jax.value_and_grad(lambda q: jmodel.loss_fn(
            q, {}, batch, jax.random.PRNGKey(0))[0])(p)
        updates, opt = tx.update(g, opt, p)
        return loss, g, optax.apply_updates(p, updates), opt

    jlosses, jstates = [], [(jparams, jopt)]
    for _ in range(3):
        loss, jgrads, jparams, jopt = jax.device_get(jax_step(jparams,
                                                              jopt))
        if not jlosses:
            first_grads = jgrads
        jlosses.append(float(loss))
        jstates.append((jparams, jopt))

    module = state.module
    device_batch = to_device_batch(batch, "cpu")
    model.compute_loss(module(device_batch, train=True,
                              generator=torch.Generator()),
                       device_batch).backward()
    grads = flax_from_state_dict({n: p.grad for n, p in
                                  module.named_parameters()})
    module.zero_grad(set_to_none=True)
    _assert_tree_close(grads["params"], first_grads, "grads")
    losses = []
    for _ in range(3):
        state, metrics = model.train_step(state, batch,
                                          torch.Generator())
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    names = [n for n, _ in state.module.named_parameters()]
    for i in range(3):
        state.module.load_state_dict(state_dict_from_flax(
            {"params": jstates[i][0]}))
        state.opt_state = optimizer_state_from_optax(jstates[i][1], names)
        state.step = i
        state, metrics = model.train_step(state, batch, torch.Generator())
        np.testing.assert_allclose(float(metrics["loss"]), jlosses[i],
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(flax_from_state_dict(
            state.module.state_dict())["params"], jstates[i + 1][0],
            "step {}".format(i + 1))


@pytest.mark.parametrize("attention", ["luong", "gnmt_v2"])
def test_convert_round_trip(attention):
    """The port's tree through ``flax_from_state_dict`` has the JAX
    model's paths and shapes, and comes back bit for bit."""
    params = _tiny_params()
    params["decoder_params"].update(attention_type=attention,
                                    weight_tied=attention == "luong")
    model = Text2Text(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    sd = model.init_state(batch).module.state_dict()
    tree = flax_from_state_dict(sd)
    jmodel = JaxText2Text(_jax_params(params), mode="eval")
    shapes = jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))["params"]
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == \
        jax.tree_util.tree_map(lambda x: x.shape, dict(shapes))
    back = state_dict_from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_c22_targets_shifted_once():
    """Targets [2, 5, 6, 7, 1] and logits[t] one-hot (+-30) on y[t + 1]:
    under the recipes' ``offset_target_by_one: True`` the port scores 0,
    the JAX package's Text2Text (which shifts, then its loss shifts again)
    60; with the loss's shift off both score 0."""
    y = np.array([[2, 5, 6, 7, 1]], np.int32)
    y_len = np.array([5], np.int32)
    logits = np.full((1, 4, 8), -30.0, np.float32)
    for t in range(4):
        logits[0, t, y[0, t + 1]] = 30.0
    batch = {"target_tensors": [y, y_len]}
    for offset, jax_want in ((True, 60.0), (False, 0.0)):
        loss_params = {"offset_target_by_one": offset,
                       "average_across_timestep": True, "tgt_vocab_size": 8,
                       "batch_size": 1}
        jmodel = JaxText2Text.__new__(JaxText2Text)
        jmodel._loss_computator = JaxSequenceLoss(dict(loss_params), None)
        jloss = float(jax.jit(lambda lg, yy, yl: jmodel.compute_loss(
            {"decoder_output": {"logits": lg}},
            {"target_tensors": [yy, yl]}))(logits, y, y_len))
        model = Text2Text.__new__(Text2Text)
        model._loss_computator = BasicSequenceLoss(dict(loss_params), None)
        loss = float(model.compute_loss(
            {"decoder_output": {"logits": torch.from_numpy(logits)}},
            {"target_tensors": [torch.from_numpy(y),
                                torch.from_numpy(y_len)]}))
        assert jloss == pytest.approx(jax_want, abs=1e-4)
        assert loss == pytest.approx(0.0, abs=1e-4)


def test_keys_without_effect():
    """C23: the decoder's keep probabilities are accepted with no effect,
    as in the JAX package; a GRU decoder (an LSTM there) and the keys that
    have no effect there are refused."""
    params = _dec_params("gnmt", decoder_dp_input_keep_prob=0.8,
                         decoder_dp_output_keep_prob=0.5)
    decoders.RNNDecoderWithAttention(params, None, mode="train")
    for bad in ({"core_cell": "gru"}, {"luong_scale": True},
                {"bahdanau_normalize": True}, {"PAD_SYMBOL": 0}):
        with pytest.raises(ValueError):
            decoders.RNNDecoderWithAttention(dict(params, **bad), None)
    for key, value in (("time_major", False), ("num_groups", 2)):
        with pytest.raises(ValueError):
            encoders.GNMTLikeEncoderWithEmbedding(
                dict(_enc_params("lstm", 3), **{key: value}), None)


def _main(*argv):
    return run.main(["--config_file=" + TINY, "--device=cpu", *argv])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_evaluates_infers(tmp_path, capsys):
    """8 steps with checkpoints at 4 and 8 (losses finite, falling), eval
    from the checkpoint ("Validation BLEU"), infer (one line a source
    sentence, in source order); on the CPU no kernel launches."""
    logdir = str(tmp_path / "logs")
    launches = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
    result = _main("--logdir=" + logdir, "--mode=train", "--max_steps=8",
                   "--save_checkpoint_steps=4", "--print_samples_steps=4")
    assert result["steps"] == 8
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert "Sample prediction:" in out
    metrics = _main("--logdir=" + logdir, "--mode=eval")
    assert "Validation BLEU" in capsys.readouterr().out
    assert np.isfinite(metrics["eval_loss"]) and "Eval BLEU" in metrics
    infer_file = str(tmp_path / "infer.txt")
    _main("--logdir=" + logdir, "--mode=infer",
          "--infer_output_file=" + infer_file)
    data = runpy.run_path(TINY)["infer_params"]["data_layer_params"]
    with open(data["source_file"]) as f:
        sources = f.read().splitlines()
    with open(infer_file) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(sources) == 16
    assert all(re.fullmatch(r"(x[0-9]{3}[qz]( x[0-9]{3}[qz])*)?", x)
               for x in lines), lines
    assert (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES) == launches


@pytest.mark.slow
def test_rnn_reversal_toy_reaches_bleu(tmp_path, monkeypatch, capsys):
    """``nmt_reversal_toy_rnn.py`` through ``run.main --mode=train_eval``
    to its end: the last "Validation BLEU" above 80 (the JAX package's
    bar for its GNMT toy, ``tests/test_rnn_nmt.py``); then eval and infer
    from its checkpoint."""
    monkeypatch.setenv("OS2S_TOY_NMT_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OS2S_TOY_NMT_LOGDIR", str(tmp_path / "logs"))
    run.main(["--config_file=" + RNN_TOY, "--device=cpu",
              "--mode=train_eval"])
    bleu = [float(x) for x in re.findall(r"Validation BLEU: ([0-9.]+)",
                                         capsys.readouterr().out)]
    assert bleu and bleu[-1] > 80.0, bleu
    metrics = run.main(["--config_file=" + RNN_TOY, "--device=cpu",
                        "--mode=eval"])
    assert metrics["Eval BLEU"] > 80.0
    out = str(tmp_path / "infer.txt")
    run.main(["--config_file=" + RNN_TOY, "--device=cpu", "--mode=infer",
              "--infer_output_file=" + out])
    with open(out) as f:
        assert len(f.read().splitlines()) == 32
