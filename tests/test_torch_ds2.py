"""The port's DeepSpeech2 slice against the JAX package's: the encoder
(``DS2Net``) on converted weights with non-trivial batch-norm statistics,
GRU and LSTM cells; then the whole tiny ``Speech2Text`` of
``example_configs_torch/speech2text/ds2_tiny_synthetic.py`` through
``eval_step`` (logits, loss, greedy transcripts) and in infer mode; the
port's ``run.main`` in eval and infer on that config; ``row_conv``
refused; and the converter's round trip through the DS2
tree (2-D conv kernels, the recurrent weights, batch norms without an
inner module).

Both sides run the fused recurrence (``fused_rnn``): the JAX side its
Pallas kernels in interpret mode, the port its kernels' plain versions.
On the CPU the JAX side's ``use_pallas`` CTC takes its XLA scan and the
port's its plain version.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on the encoder's outputs, 1e-4
on the logits and the loss (a 451-tap and a 231-tap conv, then two
recurrent layers, summed in another order); lengths and greedy ids
exact."""
import csv
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu.decoders import FullyConnectedCTCDecoder as JaxFCCTC
from openseq2seq_tpu.encoders import DeepSpeech2Encoder as JaxDS2Encoder
from openseq2seq_tpu.losses import CTCLoss as JaxCTCLoss
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.ops import gru_pallas, lstm_pallas
from openseq2seq_tpu.parts.rnns.rnn import fused_rnn_config
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict, flax_path,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders import DeepSpeech2Encoder
from openseq2seq_tpu_torch.models.model import _named_params
from openseq2seq_tpu_torch.ops import ctc_cuda, gru_scan, lstm_scan
from openseq2seq_tpu_torch.training import CheckpointManager, trainer
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                    "ds2_tiny_synthetic.py")
B, T = 8, 40
LENGTHS = np.array([40, 39, 31, 8, 40, 23, 2, 17], np.int32)


def _port_params(rnn_type, **overrides):
    params = runpy.run_path(TINY)["base_params"]
    params = dict(params, **overrides)
    params["encoder_params"] = dict(params["encoder_params"],
                                    rnn_type=rnn_type)
    return params


def _jax_params(rnn_type):
    """The tiny config with the JAX package's classes."""
    params = _port_params(rnn_type, optimizer="Adam",
                          optimizer_params={"learning_rate": 1e-3})
    params["encoder_params"] = dict(params["encoder_params"],
                                    activation_fn=jax.nn.relu)
    params.update(encoder=JaxDS2Encoder, decoder=JaxFCCTC, loss=JaxCTCLoss,
                  data_layer=SyntheticSpeechDataLayer)
    return params


def _batch():
    rng = np.random.RandomState(0)
    return {"source_tensors": [rng.randn(B, T, 32).astype(np.float32),
                               LENGTHS.copy()],
            "target_tensors": [rng.randint(0, 28, (B, 6)).astype(np.int32),
                               np.array([6, 3, 5, 1, 0, 6, 1, 4], np.int32)],
            "source_ids": np.arange(B, dtype=np.int32),
            "batch_valid": np.int32(B)}


def _interpret():
    """Run the JAX side's fused recurrence on its Pallas kernels in
    interpret mode (the fixtures put these back). Called after the JAX
    side's ``init``, which runs eagerly: its recurrences then take the
    scan, whose parameters are the same."""
    gru_pallas.FORCE_INTERPRET = lstm_pallas.FORCE_INTERPRET = True


def _both(rnn_type, mode="eval"):
    """(batch, JAX model, its eval_step output, port model, its output)
    on the same weights."""
    batch = _batch()
    jbatch = batch if mode == "eval" else {
        k: v for k, v in batch.items() if k != "target_tensors"}   # C9
    jmodel = JaxSpeech2Text(_jax_params(rnn_type), mode=mode)
    jstate = jmodel.init_state(batch)
    _interpret()
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=1)
    jstate = jstate.replace(params=variables["params"], model_state={
        "batch_stats": variables["batch_stats"]})
    jout = jax.device_get(jmodel.eval_step(jstate, jbatch))
    model = runpy.run_path(TINY)["base_model"](
        _port_params(rnn_type), mode=mode, device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    return batch, jmodel, jout, model, to_host(model.eval_step(state, batch))


@pytest.mark.parametrize("rnn_type", ["cudnn_gru", "cudnn_lstm"])
def test_encoder_matches_jax(rnn_type):
    """DS2Net alone: convs with SAME pads in both dimensions (C12), the
    flatten with channels fastest (C11), two bidirectional layers."""
    enc_params = _port_params(rnn_type)["encoder_params"]
    jenc = JaxDS2Encoder(dict(enc_params, activation_fn=jax.nn.relu),
                         model=None, mode="eval").make_module()
    x = np.random.RandomState(1).randn(B, T, 32).astype(np.float32)
    inputs = {"source_tensors": [jnp.asarray(x), jnp.asarray(LENGTHS)]}
    variables = randomize(dict(jenc.init(jax.random.PRNGKey(0), inputs,
                                         train=False)), seed=2)
    _interpret()
    with fused_rnn_config(True):
        want = jax.jit(lambda v, i: jenc.apply(v, i, train=False))(
            variables, inputs)
    model = runpy.run_path(TINY)["base_model"](_port_params(rnn_type),
                                               mode="eval", device="cpu")
    enc = DeepSpeech2Encoder(enc_params, model, mode="eval").make_module(
        32, torch.Generator().manual_seed(0))
    enc.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = enc({"source_tensors": [torch.from_numpy(x),
                                      torch.from_numpy(LENGTHS)]}, False)
    np.testing.assert_array_equal(got["src_length"].numpy(),
                                  np.asarray(want["src_length"]))
    assert got["outputs"].shape == (B, T // 2, 128)
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rnn_type", ["cudnn_gru", "cudnn_lstm"])
def test_eval_step_matches_jax(rnn_type):
    batch, jmodel, jout, model, out = _both(rnn_type)
    jdec = jout["outputs"]["decoder_output"]
    dec = out["outputs"]["decoder_output"]
    np.testing.assert_array_equal(dec["src_length"], jdec["src_length"])
    np.testing.assert_allclose(dec["logits"], jdec["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-4)
    for got, want in zip(dec["outputs"], jdec["outputs"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert model.finalize_evaluation([model.evaluate(batch, out)]) == \
        pytest.approx(jmodel.finalize_evaluation(
            [jmodel.evaluate(batch, jout)]), rel=1e-4)


def test_infer_matches_jax():
    batch, jmodel, jout, model, out = _both("cudnn_gru", mode="infer")
    assert "loss" not in out
    assert model.infer(batch, out) == jmodel.infer(batch, jout)


@pytest.fixture(scope="module")
def tiny_logdir(tmp_path_factory):
    """A seeded-init checkpoint of the tiny config."""
    logdir = str(tmp_path_factory.mktemp("ds2_tiny"))
    model = runpy.run_path(TINY)["base_model"](
        _port_params("cudnn_gru"), mode="eval", device="cpu")
    CheckpointManager(logdir).save(trainer.restore_state(model), 0)
    return logdir


def test_run_main_eval_and_infer(tiny_logdir):
    args = ["--config_file=" + TINY, "--logdir=" + tiny_logdir,
            "--device=cpu"]
    launches = (gru_scan.LAUNCHES, lstm_scan.LAUNCHES, ctc_cuda.LAUNCHES)
    metrics = run.main(args + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and metrics["eval_loss"] > 0
    assert 0.0 <= metrics["Eval WER"]
    out_csv = os.path.join(tiny_logdir, "infer.csv")
    run.main(args + ["--mode=infer", "--infer_output_file=" + out_csv])
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["wav_filename", "predicted_transcript"]
    assert len(rows) == 1 + 2 * B
    # CPU tensors: the kernels' plain versions, no launch
    assert (gru_scan.LAUNCHES, lstm_scan.LAUNCHES,
            ctc_cuda.LAUNCHES) == launches


def test_training_and_row_conv_are_refused(tmp_path):
    """``row_conv`` (no recipe sets it) is refused, in training through
    ``run.main`` before anything is written, and in eval."""
    config = tmp_path / "ds2_row_conv.py"
    config.write_text("import runpy\n_c = runpy.run_path({!r})\n"
                      "base_model = _c['base_model']\n"
                      "base_params = _c['base_params']\n"
                      "base_params['encoder_params'] = dict(\n"
                      "    base_params['encoder_params'], row_conv=True)\n"
                      .format(TINY))
    with pytest.raises(NotImplementedError, match="row_conv"):
        run.main(["--config_file=" + str(config), "--mode=train",
                  "--logdir=" + str(tmp_path / "logs"), "--device=cpu"])
    assert not os.path.exists(tmp_path / "logs" / "checkpoints")
    params = _port_params("cudnn_gru")
    params["encoder_params"] = dict(params["encoder_params"], row_conv=True)
    with pytest.raises(NotImplementedError, match="row_conv"):
        runpy.run_path(TINY)["base_model"](params, mode="eval",
                                           device="cpu")


def test_convert_round_trip():
    """flax -> port -> flax gives the tree back, leaf for leaf, and the
    port names each parameter by its flax path."""
    batch = _batch()
    jmodel = JaxSpeech2Text(_jax_params("cudnn_lstm"), mode="eval")
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=3)
    model = runpy.run_path(TINY)["base_model"](
        _port_params("cudnn_lstm"), mode="eval", device="cpu")
    module = model.init_state(batch).module
    module.load_state_dict(state_dict_from_flax(variables))
    back = flax_from_state_dict(module.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(flat_back)
    for key, value in flat.items():
        np.testing.assert_array_equal(flat_back[key], value)
    assert back["params"]["enc"]["net"]["conv2"]["kernel"].shape == \
        (11, 21, 8, 8)
    names = {"/".join(path) for path, _ in _named_params(module)}
    assert "enc/net/rnn1/bw/recurrent_kernel" in names
    assert "enc/net/conv1_bn/scale" in names
    assert flax_path("enc.net.conv1_bn.running_var",
                     {"enc.net.conv1_bn"}) == ("enc", "net", "conv1_bn", "var")
