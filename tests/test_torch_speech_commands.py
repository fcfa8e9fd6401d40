"""The port's speech-commands path against the JAX package's: the data
layer's batches on ``test_utils/fake_speech_commands`` clips equal in
both model formats, in training (shuffle, time shift and noise from the
seeded ``RandomState``) and in eval; ``FullyConnectedSCDecoder``'s masked
mean over the valid frames (and its flatten without lengths), fp32 within
rtol 1e-5 and atol 1e-5 and bf16 within 2^-6 of the logits' largest
magnitude; the tiny keyword classifier
(``jasper_speech_commands_tiny.py``: the TDNN encoder under
``Image2Label``) through ``eval_step`` on converted weights with either
decoder, the ``FullyConnectedDecoder`` of ``jasper_speech_commands.py``
flattening (B, T', C), fp32 within rtol 1e-5 and atol 1e-5; and the
port's CLI on the tiny config."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.speech2text import \
    SpeechCommandsDataLayer as JaxSCLayer
from openseq2seq_tpu.decoders import FullyConnectedDecoder as JaxFC
from openseq2seq_tpu.decoders import FullyConnectedSCDecoder as JaxSC
from openseq2seq_tpu.encoders import TDNNEncoder as JaxTDNN
from openseq2seq_tpu.losses import CrossEntropyLoss as JaxCE
from openseq2seq_tpu.models import Image2Label as JaxImage2Label
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.data.speech2text import SpeechCommandsDataLayer
from openseq2seq_tpu_torch.decoders import (FullyConnectedDecoder,
                                            FullyConnectedSCDecoder)
from openseq2seq_tpu_torch.models import Image2Label
from openseq2seq_tpu_torch.test_utils import fake_speech_commands
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_image_data import _assert_same
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                    "jasper_speech_commands_tiny.py")


@pytest.fixture(scope="module")
def sc_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("speech_commands"))
    return fake_speech_commands.generate(out, n_train=12, n_test=8, seed=1)


def _layer_params(sc_dir, mode, fmt):
    split = "train" if mode == "train" else "test"
    return {"mode": mode, "batch_size": 5,
            "dataset_files": [os.path.join(sc_dir, split + ".csv")],
            "dataset_location": sc_dir, "num_audio_features": 16,
            "audio_length": 1000, "num_labels": 8, "model_format": fmt,
            "augment_data": mode == "train"}


@pytest.mark.parametrize("fmt", ["jasper", "resnet"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_batches_equal_jax(sc_dir, mode, fmt):
    params = _layer_params(sc_dir, mode, fmt)
    layers = [cls(dict(params), model=None)
              for cls in (JaxSCLayer, SpeechCommandsDataLayer)]
    for layer in layers:
        layer.seed(3)
    want, got = (list(layer.iterate_one_epoch()) for layer in layers)
    _assert_same(want, got)
    x = got[0]["source_tensors"][0]
    assert x.shape == ((5, 16, 16, 1) if fmt == "resnet" else (5, 101, 16))
    assert layers[1].params["tgt_vocab_size"] == 8


def _sc_inputs(B=5, T=7, C=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, C).astype(np.float32),
            np.array([7, 3, 1, 6, 5][:B], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [True, False])
def test_sc_decoder_matches_jax(dtype, lengths):
    x, x_len = _sc_inputs()
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdtype = getattr(torch, dtype)

    class _Policy:
        compute_dtype = jdtype

    class _JaxModel:
        mp_policy = _Policy()

    class _TorchModel:
        mp_policy = type("P", (), {"compute_dtype": tdtype})()

    enc_out = {"outputs": jnp.asarray(x, jdtype)}
    if lengths:
        enc_out["src_length"] = jnp.asarray(x_len)
    jdec = JaxSC({"output_dim": 4}, _JaxModel()).make_module()
    variables = randomize(jdec.init(jax.random.PRNGKey(0),
                                    {"encoder_output": enc_out}, train=False),
                          seed=2)
    want = jdec.apply(variables, {"encoder_output": enc_out}, train=False)
    dec = FullyConnectedSCDecoder({"output_dim": 4}, _TorchModel())
    width = dec.input_width(x.shape[1:], lengths)
    module = dec.make_module(width, torch.Generator())
    module.load_state_dict(state_dict_from_flax(variables))
    t_out = {"outputs": torch.from_numpy(x).to(tdtype)}
    if lengths:
        t_out["src_length"] = torch.from_numpy(x_len)
    with torch.no_grad():
        got = module({"encoder_output": t_out}, False)
    assert got["logits"].dtype == torch.float32
    g, w = got["logits"].numpy(), np.asarray(want["logits"])
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
    np.testing.assert_array_equal(got["outputs"][0].numpy(),
                                  np.asarray(want["outputs"][0]))


@pytest.mark.parametrize("decoder", ["sc", "fc"])
def test_tiny_classifier_matches_jax(sc_dir, decoder, monkeypatch):
    monkeypatch.setenv("OS2S_FAKE_SC_DIR", sc_dir)
    params = dict(runpy.run_path(TINY)["base_params"],
                  batch_size_per_gpu=4)
    params["data_layer_params"] = dict(params["data_layer_params"],
                                       augment_data=False, shuffle=False)
    if decoder == "fc":
        params["decoder"] = FullyConnectedDecoder
    jparams = dict(params, encoder=JaxTDNN, loss=JaxCE,
                   data_layer=JaxSCLayer,
                   decoder=JaxSC if decoder == "sc" else JaxFC)
    jparams["encoder_params"] = dict(params["encoder_params"],
                                     activation_fn=jax.nn.relu)
    jmodel = JaxImage2Label(jparams, mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=6)
    jstate = jstate.replace(params=variables["params"], model_state={
        "batch_stats": variables["batch_stats"]})
    jout = jax.device_get(jmodel.eval_step(jstate, batch))
    model = Image2Label(params, mode="eval", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    out = to_host(model.eval_step(state, batch))
    width = state.module.dec.fully_connected.weight.shape[1]
    assert width == (16 if decoder == "sc" else 51 * 16)
    np.testing.assert_allclose(out["outputs"]["decoder_output"]["logits"],
                               np.asarray(jout["outputs"]["decoder_output"]
                                          ["logits"], np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["loss"], float(jout["loss"]), rtol=1e-5,
                               atol=1e-5)


def test_run_main_tiny(sc_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OS2S_FAKE_SC_DIR", sc_dir)
    run.main(["--config_file=" + TINY, "--mode=train_eval", "--device=cpu",
              "--logdir=" + str(tmp_path), "--max_steps=4",
              "--eval_steps=4", "--print_loss_steps=2"])
    printed = capsys.readouterr().out
    assert "Global step 4: loss = " in printed
    assert "Validation top-1" in printed
