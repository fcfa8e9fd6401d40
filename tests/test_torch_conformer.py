"""The port's Conformer slice against the JAX package's: the tiny
``Speech2Text`` of ``example_configs_torch/speech2text/
conformer_tiny_synthetic.py`` built in both packages, the port on the JAX
model's weights carried by ``convert.py`` (and back, leaf for leaf),
through ``eval_step`` (encoder outputs, logits, loss, greedy transcripts)
with both kernel flags on and both off, and in infer mode; then the
port's ``run.main`` in eval and infer on that config.

With the flags on, the JAX side runs its Pallas kernels in interpret mode
(``FORCE_INTERPRET``, set for the test and put back) and the port its
kernels' plain versions; on the CPU the JAX side's ``use_pallas`` CTC
takes its XLA scan and the port's its plain version.

Tolerance: fp32, rtol and atol 1e-4 on the encoder outputs, the logits
and the loss (two blocks of sums in another order); lengths and greedy
ids exact."""
import csv
import os
import runpy

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu.decoders import FullyConnectedCTCDecoder as JaxFCCTC
from openseq2seq_tpu.encoders import ConformerEncoder as JaxConformer
from openseq2seq_tpu.losses import CTCLoss as JaxCTCLoss
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.ops import conformer_pallas, flash_relpos
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.models.model import _named_params
from openseq2seq_tpu_torch.ops import conformer_conv, ctc_cuda
from openseq2seq_tpu_torch.ops import flash_relpos as port_flash_relpos
from openseq2seq_tpu_torch.training import CheckpointManager, trainer
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                    "conformer_tiny_synthetic.py")
B, T = 4, 40
LENGTHS = np.array([40, 33, 5, 21], np.int32)
FLAGS = {"on": True, "off": False}


def _port_params(flags="on"):
    params = dict(runpy.run_path(TINY)["base_params"])
    params["encoder_params"] = dict(params["encoder_params"],
                                    flash_attention=FLAGS[flags],
                                    fused_conv_module=FLAGS[flags])
    return params


def _jax_params(flags):
    params = dict(_port_params(flags), encoder=JaxConformer,
                  decoder=JaxFCCTC, loss=JaxCTCLoss,
                  data_layer=SyntheticSpeechDataLayer, optimizer="Adam",
                  optimizer_params={"learning_rate": 1e-3})
    params["encoder_params"] = dict(params["encoder_params"],
                                    dropout_keep_prob=1.0)
    return params


def _batch():
    rng = np.random.RandomState(0)
    return {"source_tensors": [rng.randn(B, T, 16).astype(np.float32),
                               LENGTHS.copy()],
            "target_tensors": [rng.randint(0, 28, (B, 6)).astype(np.int32),
                               np.array([6, 3, 1, 4], np.int32)],
            "source_ids": np.arange(B, dtype=np.int32),
            "batch_valid": np.int32(B)}


def _randomize(params, seed):
    """Random norm scales and biases (initialized to 1 and 0), so that a
    wrong mapping shows."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value)
            elif key.endswith("bias"):
                out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
            elif key.endswith("scale"):
                out[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)
            else:
                out[key] = np.asarray(value)
        return out
    return walk(jax.device_get(params))


def _both(flags, mode="eval", monkeypatch=None):
    """(batch, JAX model, its eval_step output, port model, its output,
    the flax params) on the same weights."""
    batch = _batch()
    jbatch = batch if mode == "eval" else {
        k: v for k, v in batch.items() if k != "target_tensors"}   # C9
    jmodel = JaxSpeech2Text(_jax_params(flags), mode=mode)
    jstate = jmodel.init_state(batch)
    params = _randomize(jstate.params, seed=1)
    jstate = jstate.replace(params=params)
    if flags == "on":
        monkeypatch.setattr(flash_relpos, "FORCE_INTERPRET", True)
        monkeypatch.setattr(conformer_pallas, "FORCE_INTERPRET", True)
    jout = jax.device_get(jmodel.eval_step(jstate, jbatch))
    model = runpy.run_path(TINY)["base_model"](_port_params(flags), mode=mode,
                                               device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax({"params": params}))
    return batch, jmodel, jout, model, to_host(model.eval_step(state, batch)), \
        state.module, params


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_eval_step_matches_jax(flags, monkeypatch):
    batch, jmodel, jout, model, out, _, _ = _both(flags,
                                                  monkeypatch=monkeypatch)
    jenc = jout["outputs"]["encoder_output"]
    enc = out["outputs"]["encoder_output"]
    np.testing.assert_array_equal(enc["src_length"], jenc["src_length"])
    assert enc["outputs"].shape == (B, T // 4, 128)
    np.testing.assert_allclose(enc["outputs"], jenc["outputs"], rtol=1e-4,
                               atol=1e-4)
    jdec = jout["outputs"]["decoder_output"]
    dec = out["outputs"]["decoder_output"]
    np.testing.assert_allclose(dec["logits"], jdec["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-4)
    for got, want in zip(dec["outputs"], jdec["outputs"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert model.finalize_evaluation([model.evaluate(batch, out)]) == \
        pytest.approx(jmodel.finalize_evaluation(
            [jmodel.evaluate(batch, jout)]), rel=1e-4)


def test_infer_and_convert_round_trip(monkeypatch):
    """Infer transcripts agree; flax -> port -> flax gives the tree back
    leaf for leaf, and the port names each parameter by its flax path."""
    batch, jmodel, jout, model, out, module, params = _both(
        "on", mode="infer", monkeypatch=monkeypatch)
    assert "loss" not in out
    assert model.infer(batch, out) == jmodel.infer(batch, jout)
    back = flax_from_state_dict(module.state_dict(),
                                layer_norm_modules(module))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(
        back["params"])[0])
    assert set(flat) == set(flat_back) and not back["batch_stats"]
    for key, value in flat.items():
        np.testing.assert_array_equal(flat_back[key], value)
    block = back["params"]["enc"]["net"]["block1"]
    assert block["attn"]["q"]["kernel"].shape == (128, 4, 32)
    assert block["attn"]["out"]["kernel"].shape == (4, 32, 128)
    assert block["conv"]["dw_kernel"].shape == (7, 128)
    names = {"/".join(path) for path, _ in _named_params(module)}
    assert {"enc/net/block0/ffn1/LayerNorm_0/scale",
            "enc/net/block0/attn_ln/scale", "enc/net/block0/attn/r/kernel",
            "enc/net/block0/conv/pw1_kernel",
            "enc/net/sub_conv1/kernel"} <= names


@pytest.fixture(scope="module")
def tiny_logdir(tmp_path_factory):
    """A seeded-init checkpoint of the tiny config."""
    logdir = str(tmp_path_factory.mktemp("conformer_tiny"))
    model = runpy.run_path(TINY)["base_model"](_port_params(), mode="eval",
                                               device="cpu")
    CheckpointManager(logdir).save(trainer.restore_state(model), 0)
    return logdir


def test_run_main_eval_and_infer(tiny_logdir, capsys):
    args = ["--config_file=" + TINY, "--logdir=" + tiny_logdir,
            "--device=cpu"]
    launches = (port_flash_relpos.LAUNCHES, conformer_conv.LAUNCHES,
                ctc_cuda.LAUNCHES)
    metrics = run.main(args + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and metrics["eval_loss"] > 0
    assert "Validation WER" in capsys.readouterr().out
    out_csv = os.path.join(tiny_logdir, "infer.csv")
    run.main(args + ["--mode=infer", "--infer_output_file=" + out_csv])
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["wav_filename", "predicted_transcript"]
    assert len(rows) == 1 + 2 * B
    # CPU tensors: the kernels' plain versions, no launch
    assert (port_flash_relpos.LAUNCHES, conformer_conv.LAUNCHES,
            ctc_cuda.LAUNCHES) == launches
