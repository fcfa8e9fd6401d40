"""The port's ASR front end and interactive inference against the JAX
package's:

  * ``ops/features_device.logmel_features`` against
    ``features_jax.logmel_features`` on a ragged batch of a few hundred
    ms of audio, per feature and over all features: within 1e-4 (the
    normalized features are O(1)); lengths exact. A planted fault, the
    periodic Hann window (``torch.hann_window``'s default) in place of
    ``np.hanning``'s symmetric one, must miss that tolerance;
  * ``featurize_on_device``: the data layer's padded raw-audio batches
    equal the JAX layer's, and the model's featurizing forward on them
    (the eval logits and loss of a small Wave2Letter model on converted
    weights, under the JAX wrapper's ``inner``) within rtol 1e-4, atol
    1e-4; the frames counted a step as the JAX model counts them;
  * interactive batches of one wav, from its path and from (signal, rate),
    with host features and with raw audio, equal to the JAX layer's; the
    port's ``run.py`` REPL on them prints each wav's transcript and an
    error line for a wav that does not exist;
  * the GatedConv tutorial encoder: outputs and the gradient of every
    parameter and of the input, fp32, rtol 1e-5 and atol 1e-5 (gradients
    atol 1e-5 of max(1, the leaf's largest magnitude)); its flax names
    round-trip through ``convert.py``; its schema refuses unknown keys;
  * marked slow: the on-device toy to "Validation WER: 0.0000" and the
    GatedConv toy to an eval loss below 1.0, as the JAX tests require."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from openseq2seq_tpu.data.speech2text import \
    Speech2TextDataLayer as JaxSpeech2TextDataLayer
from openseq2seq_tpu.encoders import GatedConvEncoder as JaxGatedConv
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.ops.features_jax import \
    logmel_features as jax_logmel
from openseq2seq_tpu.test_utils.test_speech_configs import \
    w2l_test_config as jax_w2l_config
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.encoders import GatedConvEncoder
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.ops import features_device
from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
    w2l_test_config
from openseq2seq_tpu_torch.training import trainer
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

FEAT_ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _audio(seed=0):
    rng = np.random.RandomState(seed)
    n = 4800                                       # 0.3 s at 16 kHz
    t = np.arange(n) / 16000.0
    x = np.stack([np.sin(2 * np.pi * f * t) * 0.5 for f in (440, 950, 170)])
    x = (x + 0.05 * rng.randn(3, n)).astype(np.float32)
    lengths = np.array([n, 3333, 1601], np.int32)
    return x, lengths


def _features(norm_per_feature):
    x, lengths = _audio()
    kw = dict(num_features=40, n_fft=512, hop_length=160, win_length=320,
              norm_per_feature=norm_per_feature)
    want, want_len = jax_logmel(jnp.asarray(x), jnp.asarray(lengths), **kw)
    got, got_len = features_device.logmel_features(
        torch.from_numpy(x), torch.from_numpy(lengths), **kw)
    return got.numpy(), got_len.numpy(), np.asarray(want), \
        np.asarray(want_len)


@pytest.mark.parametrize("norm_per_feature", [True, False])
def test_logmel_features_match_jax(norm_per_feature):
    got, got_len, want, want_len = _features(norm_per_feature)
    assert got.shape == want.shape == (3, 31, 40)
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    assert np.all(got[2, int(got_len[2]):] == 0)


def test_periodic_window_is_refused(monkeypatch):
    def periodic(win_length, n_fft, device):
        w = torch.hann_window(win_length, dtype=torch.float64)
        lo = (n_fft - win_length) // 2
        return torch.nn.functional.pad(
            w, (lo, n_fft - win_length - lo)).float()
    monkeypatch.setattr(features_device, "_window", periodic)
    for norm_per_feature in (True, False):
        got, _, want, _ = _features(norm_per_feature)
        assert np.abs(got - want).max() > FEAT_ATOL


def _narrow(params):
    for layer in params["encoder_params"]["convnet_layers"]:
        layer["num_channels"] //= 4
    return params


def _ondevice(config, toy):
    params = _narrow(config(toy["csv"], toy["vocab"])[0])
    params["data_layer_params"] = dict(params["data_layer_params"],
                                       featurize_on_device=True,
                                       shuffle=False)
    params["batch_size_per_gpu"] = 4
    return params


def test_featurize_on_device_matches_jax(toy_speech_data,
                                         jax_globals):  # noqa: F811
    jmodel = JaxSpeech2Text(_ondevice(jax_w2l_config, toy_speech_data),
                            mode="eval")
    model = Speech2Text(_ondevice(w2l_test_config, toy_speech_data),
                        mode="eval", device="cpu")
    jbatch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    assert batch["source_tensors"][0].ndim == 2
    assert batch["source_tensors"][0].shape[1] % (160 * 16) == 0
    for key in ("source_tensors", "target_tensors"):
        for a, b in zip(batch[key], jbatch[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(batch["source_ids"], jbatch["source_ids"])
    assert model.get_num_objects_per_step(batch) == \
        jmodel._get_num_objects_per_step(jbatch)

    jstate = jmodel.init_state(jbatch)
    variables = randomize({"params": jstate.params,
                           **dict(jstate.model_state)}, seed=4)
    assert list(variables["params"]) == ["inner"]
    jstate = jstate.replace(
        params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"})
    want = jax.jit(jmodel.eval_step)(jstate, jbatch)
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    got = trainer.to_host(model.eval_step(state, batch))
    for key in ("logits", "src_length"):
        np.testing.assert_allclose(
            got["outputs"]["decoder_output"][key],
            np.asarray(want["outputs"]["decoder_output"][key]),
            rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-4)


@pytest.mark.parametrize("on_device", [False, True])
def test_interactive_batches_match_jax(toy_speech_data, on_device):
    params = {"num_audio_features": 40, "input_type": "logfbank",
              "vocab_file": toy_speech_data["vocab"],
              "dataset_files": [toy_speech_data["csv"]], "pad_to": 16,
              "norm_per_feature": True, "window": "hanning",
              "precompute_mel_basis": True, "sample_freq": 16000,
              "batch_size": 1, "mode": "infer", "interactive": True,
              "featurize_on_device": on_device}
    mine = Speech2TextDataLayer(dict(params), None)
    theirs = JaxSpeech2TextDataLayer(dict(params), None)
    assert mine.get_size_in_samples() == 0
    wav = os.path.join(toy_speech_data["dir"], "toy_3.wav")
    _, signal = wavfile.read(wav)
    for model_in in (wav, (signal.astype(np.float32), 16000)):
        got = mine.create_interactive_batch(model_in)
        want = theirs.create_interactive_batch(model_in)
        assert sorted(got) == sorted(want)
        for a, b in zip(got["source_tensors"], want["source_tensors"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert int(got["batch_valid"]) == 1


def test_interactive_repl_prints_transcripts(toy_speech_data):
    params = _narrow(w2l_test_config(toy_speech_data["csv"],
                                     toy_speech_data["vocab"])[0])
    model = Speech2Text(params, mode="interactive_infer", device="cpu")
    wavs = [os.path.join(toy_speech_data["dir"], "toy_{}.wav".format(i))
            for i in (0, 1)]
    printed = run.interactive_repl(model, None, lines=[
        wavs[0], "", "/nonexistent/x.wav", wavs[1]])
    assert len(printed) == 3 and printed[1].startswith("error: ")
    state = trainer.restore_state(model, None)
    for wav, text in zip(wavs, (printed[0], printed[2])):
        batch = model.get_data_layer().create_interactive_batch(wav)
        out = trainer.to_host(model.eval_step(state, batch))
        assert text == model.infer(batch, out)[0][1]


def _gated(hidden=32, layers=2, kernel=5):
    return {"num_layers": layers, "hidden_size": hidden,
            "kernel_size": kernel, "dropout_keep_prob": 0.9}


def test_gatedconv_matches_jax_with_gradients():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 19, 12).astype(np.float32)
    lengths = np.array([19, 14, 7], np.int32)
    jmod = JaxGatedConv(_gated(), model=None, mode="eval").make_module()
    variables = randomize(jmod.init(jax.random.PRNGKey(0),
                                    {"source_tensors": [x, lengths]},
                                    train=False), seed=2)
    cot = rng.randn(3, 10, 32).astype(np.float32)

    def jloss(params, xx):
        out = jmod.apply({"params": params},
                         {"source_tensors": [xx, lengths]}, train=False)
        return jnp.sum(out["outputs"] * cot), out
    (_, want), (jgrad, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    module = GatedConvEncoder(_gated(), model=None, mode="eval") \
        .make_module(12, torch.Generator().manual_seed(0))
    module.load_state_dict(state_dict_from_flax(variables))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = module({"source_tensors": [xt, torch.from_numpy(lengths)]},
                 train=False)
    (got["outputs"] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got["outputs"].detach().numpy(),
                               np.asarray(want["outputs"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  np.asarray(want["src_length"]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    grads = {n: p.grad for n, p in module.named_parameters()}
    got_grads = flax_from_state_dict(grads)["params"]
    want_grads = jax.tree_util.tree_map(np.asarray, jgrad)
    assert jax.tree_util.tree_structure(got_grads) == \
        jax.tree_util.tree_structure(want_grads)
    assert sorted(want_grads["net"]) == ["LayerNorm_0", "LayerNorm_1",
                                         "conv0", "conv1", "front"]
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_grads),
                            jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
    back = flax_from_state_dict(module.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           variables["params"])
    with pytest.raises(ValueError, match="not_a_real_key"):
        GatedConvEncoder(dict(_gated(), not_a_real_key=1), model=None)


def _toy_run(config, tmp_path, toy, monkeypatch):
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", toy["dir"])
    monkeypatch.setenv("OS2S_TOY_LOGDIR", str(tmp_path))
    return run.main(["--config_file=" + os.path.join(
        REPO, "example_configs_torch", "speech2text", config),
        "--mode=train_eval", "--device=cpu"])


@pytest.mark.slow
def test_ondevice_toy_reaches_wer_zero(tmp_path, toy_speech_data, capsys,
                                       monkeypatch):
    _toy_run("w2lplus_toy_ondevice.py", tmp_path, toy_speech_data,
             monkeypatch)
    assert "Validation WER: 0.0000" in capsys.readouterr().out


@pytest.mark.slow
def test_gatedconv_toy_converges(tmp_path, toy_speech_data, monkeypatch):
    import runpy
    result = _toy_run("gatedconv_toy.py", tmp_path, toy_speech_data,
                      monkeypatch)
    params = dict(runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "gatedconv_toy.py"))["base_params"])
    params["data_layer_params"] = dict(params["data_layer_params"],
                                       shuffle=False)
    metrics = trainer.evaluate_with_state(
        Speech2Text(params, mode="eval", device="cpu"), result["state"])
    assert metrics["eval_loss"] < 1.0, metrics
