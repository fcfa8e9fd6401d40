"""The port's ConvS2S against the JAX package's, on the same inputs (from
numpy with fixed seeds) and converted weights (every leaf moved by N(0,
0.05^2), so that zero-initialized biases and a wrong mapping show):

  * the encoder's outputs and attention values, and the gradients of a
    weighted sum of both, in training with dropout off (keep 1.0); with
    and without the residual and embedding projections;
  * the decoder's teacher-forced logits and the gradients of a weighted
    sum of them, with the encoder's values and with a plain encoder's
    outputs alone (the RC wiring);
  * "mixed" (bf16 compute): outputs and logits within 2^-5 of max(1,
    |value|);
  * the beam-4 decoded ids, lengths and scores;
  * C27: no weight normalization (the tree holds plain kernels, as the
    JAX module's), ``shared_embed`` without effect;
  * the converter's round trip, the full-width parameter count by
    ``jax.eval_shape`` (and ``chip_smoke.py``'s copy of it);
  * ``run.main`` on the tiny config in train, eval and infer, and the CR
    and RC toys' wiring for a train step each;
  * (slow) the ConvS2S reversal toy to a "Validation BLEU" above 70, the
    JAX test's bar.

Tolerance: fp32 rtol 1e-5, atol 1e-5 on outputs and logits; a gradient
within 1e-5 of its leaf's largest magnitude plus rtol 1e-5; "mixed" as
above.
"""
import copy
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
from openseq2seq_tpu.data.text2text import \
    ParallelTextDataLayer as JaxParallelText
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu.models import Text2Text as JaxText2Text
from openseq2seq_tpu_torch import decoders, encoders, run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.models import Text2Text
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
# the tiny config's corpus in a directory of this module's own, and
# torch on one thread
from test_torch_text_data import one_thread, tiny_corpus_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2text")
TINY = os.path.join(CONFIGS, "convs2s_tiny_wmt.py")
TOY = os.path.join(CONFIGS, "nmt_reversal_toy_convs2s.py")
B, S, T, V = 4, 9, 7, 14
SRC_LEN = np.array([9, 4, 1, 7], np.int32)
Y_LEN = np.array([7, 5, 2, 6], np.int32)
CONV = [[16, 3], [24, 3], [24, 1]]
GRAD_ATOL = 1e-5


def _leaves_perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, dict(variables)))


def _perturbed_weights(module, seed):
    """The port module's weights, perturbed, loaded back into it, and as
    flax variables for the JAX module."""
    variables = _leaves_perturbed(flax_from_state_dict(module.state_dict()),
                                  seed)
    module.load_state_dict(state_dict_from_flax(variables))
    return {k: v for k, v in variables.items() if v}


def _grads(module):
    """The gradients as a flax tree; zeros where none flowed (WaveNet's
    last ``_res`` conv feeds nothing)."""
    return flax_from_state_dict({
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in module.named_parameters()})["params"]


def assert_grads_close(got, want):
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        w = np.asarray(w)
        np.testing.assert_allclose(
            flat[path], w, rtol=1e-5, atol=GRAD_ATOL * np.abs(w).max(),
            err_msg="/".join(k.key for k in path))


def assert_bf16_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2.0 ** -5, err.max()


def _ids(shape, seed, low=3):
    return np.random.RandomState(seed).randint(low, V, shape).astype(
        np.int32)


def _enc_params(conv=CONV, E=16, **extra):
    return dict({"src_emb_size": E, "src_vocab_size": V,
                 "pad_embeddings_2_eight": False,
                 "conv_nchannels_kwidth": conv,
                 "embedding_dropout_keep_prob": 1.0,
                 "hidden_dropout_keep_prob": 1.0, "max_input_length": 32},
                **extra)


def _dec_params(conv=CONV, E=16, **extra):
    return dict({"batch_size": B, "tgt_emb_size": E, "tgt_vocab_size": V,
                 "shared_embed": False, "embedding_dropout_keep_prob": 1.0,
                 "conv_nchannels_kwidth": conv,
                 "hidden_dropout_keep_prob": 1.0,
                 "out_dropout_keep_prob": 1.0, "beam_size": 4, "alpha": 0.6,
                 "extra_decode_length": 4, "EOS_ID": 1, "GO_SYMBOL": 2,
                 "out_emb_size": 20, "max_input_length": 32}, **extra)


def _enc_inputs():
    ids = _ids((B, S), 0)
    return ({"source_tensors": [jnp.asarray(ids), jnp.asarray(SRC_LEN)]},
            {"source_tensors": [torch.from_numpy(ids),
                                torch.from_numpy(SRC_LEN)]})


@pytest.mark.parametrize("conv,E", [(CONV, 16), ([[16, 3]] * 2, 16)],
                         ids=["projections", "same-width"])
def test_encoder_matches_jax(conv, E):
    params = _enc_params(conv, E)
    jenc = jax_encoders.ConvS2SEncoder(params, None).make_module()
    enc = encoders.ConvS2SEncoder(params, None).make_module(
        0, torch.Generator().manual_seed(0))
    assert (enc.emb_proj is None) == (conv[-1][0] == E)
    variables = _perturbed_weights(enc, 1)
    jin, tin = _enc_inputs()
    rng = np.random.RandomState(2)
    w_out = rng.randn(B, S, conv[-1][0]).astype(np.float32)
    w_val = rng.randn(B, S, conv[-1][0]).astype(np.float32)

    @jax.jit
    def jax_run(v):
        def objective(p):
            out = jenc.apply({"params": p}, jin, train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out["outputs"] * w_out) + jnp.sum(
                out["attention_values"] * w_val), out
        (_, out), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        return out, g

    want, want_grads = jax.device_get(jax_run(variables))
    got = enc(tin, True, torch.Generator())
    for key in ("outputs", "attention_values"):
        np.testing.assert_allclose(got[key].detach().numpy(), want[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    ((got["outputs"] * torch.from_numpy(w_out)).sum() +
     (got["attention_values"] * torch.from_numpy(w_val)).sum()).backward()
    assert_grads_close(_grads(enc), want_grads)


def _dec_inputs(E_enc=24, values=True):
    rng = np.random.RandomState(3)
    memory = rng.randn(B, S, E_enc).astype(np.float32)
    y = _ids((B, T), 4)
    y[:, 0] = 2
    enc = {"outputs": memory, "src_length": SRC_LEN}
    if values:
        enc["attention_values"] = rng.randn(B, S, E_enc).astype(np.float32)
    jin = {"encoder_output": {k: jnp.asarray(v) for k, v in enc.items()},
           "target_tensors": [jnp.asarray(y), jnp.asarray(Y_LEN)]}
    tin = {"encoder_output": {k: torch.from_numpy(v)
                              for k, v in enc.items()},
           "target_tensors": [torch.from_numpy(y), torch.from_numpy(Y_LEN)]}
    return jin, tin


def _decoders(params, mode, seed, E_enc=24):
    jdec = jax_decoders.ConvS2SDecoder(params, None, mode=mode) \
        .make_module()
    dec = decoders.ConvS2SDecoder(params, None, mode=mode).make_module(
        E_enc, torch.Generator().manual_seed(0))
    return jdec, _perturbed_weights(dec, seed), dec


@pytest.mark.parametrize("values", [True, False], ids=["cc", "rc"])
def test_decoder_teacher_forced_matches_jax(values):
    """Training with dropout off: the logits and the gradients of a
    weighted sum of them; with the ConvS2S encoder's values, and with an
    RNN encoder's outputs alone (keys and values the same)."""
    params = _dec_params()
    jdec, variables, dec = _decoders(params, "train", 5)
    jin, tin = _dec_inputs(values=values)
    weights = np.random.RandomState(6).randn(B, T - 1, V).astype(np.float32)

    @jax.jit
    def jax_run(v):
        def objective(p):
            out = jdec.apply({"params": p}, jin, train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out["logits"] * weights), out["logits"]
        (_, logits), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        return logits, g

    want, want_grads = jax.device_get(jax_run(variables))
    got = dec(tin, True, torch.Generator())
    assert got["logits"].shape == (B, T - 1, V)
    assert "outputs" not in got
    np.testing.assert_allclose(got["logits"].detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    (got["logits"] * torch.from_numpy(weights)).sum().backward()
    assert_grads_close(_grads(dec), want_grads)


@pytest.fixture
def jax_sigmoid_rounded_once(monkeypatch):
    """XLA's CPU backend expands a bf16 logistic into bf16 steps (exp, add,
    divide, each rounded: a third of the outputs differ from the exactly
    rounded sigmoid); the JAX side takes it in fp32 and rounds once, as
    torch computes it."""
    sigmoid = jax.nn.sigmoid
    monkeypatch.setattr(jax.nn, "sigmoid", lambda x: sigmoid(
        x.astype(jnp.float32)).astype(x.dtype))


def test_mixed_matches_jax(jax_sigmoid_rounded_once):
    """bf16 compute, the encoder and then the decoder on the encoder's
    outputs: each output within 2^-5 of max(1, |value|). The JAX side runs
    op by op (no ``jit``: under ``jit`` XLA's fusions round elsewhere, and
    its logits move by up to 0.058 of that scale from its own op-by-op
    ones at this size); each operation then rounds where the port's does,
    the scalar factors rounded to bf16 first, as JAX's weak types are
    (``weak_scalar``)."""
    eparams = _enc_params(dtype="mixed")
    jenc = jax_encoders.ConvS2SEncoder(eparams, None).make_module()
    enc = encoders.ConvS2SEncoder(eparams, None).make_module(
        0, torch.Generator().manual_seed(0))
    assert enc.dtype == torch.bfloat16
    ev = _perturbed_weights(enc, 7)
    jin, tin = _enc_inputs()
    want = jenc.apply(ev, jin, train=False)
    with torch.no_grad():
        got = enc(tin, False)
    for key in ("outputs", "attention_values"):
        assert got[key].dtype == torch.bfloat16
        assert_bf16_close(got[key], want[key])
    # the decoders read their compute type from the model's policy
    model = type("Model", (), {"params": {}, "mp_policy": type(
        "Policy", (), {"compute_dtype": torch.bfloat16})})()
    dparams = _dec_params(tgt_emb_size=24)
    dec = decoders.ConvS2SDecoder(dparams, model, mode="train").make_module(
        CONV[-1][0], torch.Generator().manual_seed(0))
    assert dec.dtype == torch.bfloat16
    dv = _perturbed_weights(dec, 8)
    jdec = jax_decoders.ConvS2SDecoder(dparams, None, mode="train") \
        .make_module().clone(dtype_=jnp.bfloat16)
    y = jnp.asarray(_ids((B, T), 4))
    want = jdec.apply(dv, {"encoder_output": want, "target_tensors": [
        y, jnp.asarray(Y_LEN)]}, train=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = dec({"encoder_output": got, "target_tensors": [
            torch.from_numpy(np.array(y)), torch.from_numpy(Y_LEN)]},
            True, torch.Generator())
    assert_bf16_close(got["logits"], want["logits"])


def test_beam_decode_matches_jax():
    """Beam 4 from the encoder output: ids, lengths and scores."""
    params = _dec_params()
    jdec, variables, dec = _decoders(params, "infer", 9)
    jin, tin = _dec_inputs()
    want = jax.jit(lambda v: jdec.apply(
        v, {"encoder_output": jin["encoder_output"]}, train=False))(
            variables)
    with torch.no_grad():
        got = dec({"encoder_output": tin["encoder_output"]}, False)
    ids, lengths = got["outputs"]
    assert ids.shape == (B, S + 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want["outputs"][0]))
    np.testing.assert_array_equal(lengths.numpy(),
                                  np.asarray(want["outputs"][1]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-5,
                               atol=1e-5)


def _tiny_params(**overrides):
    params = copy.deepcopy(runpy.run_path(TINY)["base_params"])
    params.update(overrides)
    return params


def _jax_params(params):
    return dict(params, encoder=jax_encoders.ConvS2SEncoder,
                decoder=jax_decoders.ConvS2SDecoder,
                loss=JaxSequenceLoss, data_layer=JaxParallelText)


def _jax_shapes(params):
    jmodel = JaxText2Text(_jax_params(params), mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    return jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))["params"]


def test_convert_round_trip_and_c27():
    """The port's tree through ``flax_from_state_dict`` has the JAX
    model's paths and shapes and comes back bit for bit (C27: plain conv
    kernels and biases, no weight-norm leaves, on both sides; the
    decoder's own tables although ``shared_embed`` is set)."""
    params = _tiny_params()
    assert params["decoder_params"]["shared_embed"]
    model = Text2Text(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    sd = model.build_module(batch, torch.Generator().manual_seed(0)) \
        .state_dict()
    tree = flax_from_state_dict(sd)["params"]
    shapes = _jax_shapes(params)
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda x: x.shape, dict(shapes))
    leaves = {k.key for path, _ in jax.tree_util.tree_flatten_with_path(
        tree)[0] for k in path[-1:]}
    assert leaves == {"kernel", "bias", "embedding", "pos_embedding"}
    assert "embedding" in tree["dec"] and "embedding" in tree["enc"]
    back = state_dict_from_flax({"params": tree})
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_full_width_parameter_count():
    """``en_de_convs2s_wmt.py`` at the recipe's width on the tiny corpus's
    files: the port's parameter count is the JAX model's (by
    ``jax.eval_shape`` of its init), and ``chip_smoke.py`` holds it."""
    import chip_smoke
    tiny = _tiny_params()
    params = copy.deepcopy(runpy.run_path(os.path.join(
        CONFIGS, "en_de_convs2s_wmt.py"))["base_params"])
    params["data_layer_params"] = tiny["data_layer_params"]
    count = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(_jax_shapes(params)))
    model = Text2Text(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    with torch.device("meta"):
        module = model.build_module(batch, None)
    assert sum(p.numel() for p in module.parameters()) == count == \
        chip_smoke.CONVS2S_PARAMS


def _main(config, *argv):
    return run.main(["--config_file=" + config, "--device=cpu", *argv])


def test_run_main_trains_evaluates_infers(tmp_path, capsys):
    """The tiny config: 6 steps (8-bit dropout masks) with checkpoints at
    3 and 6, the losses finite; eval from the checkpoint ("Validation
    BLEU"); infer, one line a source sentence."""
    logdir = str(tmp_path / "logs")
    result = _main(TINY, "--logdir=" + logdir, "--mode=train",
                   "--max_steps=6", "--save_checkpoint_steps=3")
    assert result["steps"] == 6
    losses = [float(x) for x in re.findall(r"loss = ([0-9.]+)",
                                           capsys.readouterr().out)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    metrics = _main(TINY, "--logdir=" + logdir, "--mode=eval")
    assert "Validation BLEU" in capsys.readouterr().out
    assert np.isfinite(metrics["eval_loss"])
    out = str(tmp_path / "infer.txt")
    _main(TINY, "--logdir=" + logdir, "--mode=infer",
          "--infer_output_file=" + out)
    with open(out) as f:
        assert len(f.read().splitlines()) == 16


@pytest.mark.parametrize("name", ["nmt_reversal_toy_cr.py",
                                  "nmt_reversal_toy_rc.py"])
def test_mixed_wirings_train(name, tmp_path, monkeypatch):
    """The CR and RC toys (a ConvS2S encoder under an RNN decoder, an RNN
    encoder under a ConvS2S decoder), cut to two steps: the losses
    finite."""
    from openseq2seq_tpu_torch.training import trainer
    monkeypatch.setenv("OS2S_TOY_NMT_DIR", str(tmp_path / "data"))
    params = copy.deepcopy(runpy.run_path(os.path.join(CONFIGS, name))[
        "base_params"])
    del params["num_epochs"]
    params.update(max_steps=2, logdir=str(tmp_path / "logs"),
                  print_loss_steps=1)
    result = trainer.train(Text2Text(params, mode="train", device="cpu"))
    assert result["steps"] == 2
    assert np.isfinite(float(result["last_metrics"]["loss"]))


@pytest.mark.slow
def test_convs2s_reversal_toy_reaches_bleu(tmp_path, monkeypatch, capsys):
    """``nmt_reversal_toy_convs2s.py`` through ``run.main
    --mode=train_eval`` to its end: the last "Validation BLEU" above 70
    (``tests/test_convs2s.py``'s bar)."""
    monkeypatch.setenv("OS2S_TOY_NMT_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OS2S_TOY_NMT_LOGDIR", str(tmp_path / "logs"))
    _main(TOY, "--mode=train_eval")
    bleu = [float(x) for x in re.findall(r"Validation BLEU: ([0-9.]+)",
                                         capsys.readouterr().out)]
    assert bleu and bleu[-1] > 70.0, bleu
