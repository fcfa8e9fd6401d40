"""The port's eval/infer slice against the JAX package's, end to end:
Speech2Text on Jasper (cut to 2 blocks x 2 sub-layers, 1/8 width), the
same converted weights and batch, through ``eval_step``: logits, loss,
greedy ids and WER. Then the port's ``run.main`` in eval and infer modes
on a tiny config, and what train mode refuses
(test_torch_jasper_train.py holds the training slice). On the CPU the JAX side's ``use_pallas`` takes its XLA
scan and the port's its plain version; test_torch_ctc.py holds those
against the Pallas kernel in interpret mode.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on logits and loss; ids and WER
exact. Under "mixed" (bf16 compute) the logits only, at rtol 2e-2 and
atol 2e-2: the two frameworks round to bf16 at the same places but
accumulate their convs in different orders."""
import csv
import os

import jax
import numpy as np
import pytest

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.zoo import jasper_model_params as jax_jasper_params
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.ops import ctc_cuda
from openseq2seq_tpu_torch.training import CheckpointManager, trainer
from openseq2seq_tpu_torch.training.trainer import to_host
from openseq2seq_tpu_torch.zoo import jasper_model_params
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

FEATURES, VOCAB, T, L, B = 16, 29, 41, 6, 4
DATA = {"num_audio_features": FEATURES, "tgt_vocab_size": VOCAB,
        "time_steps": T, "label_length": L, "num_batches": 2}
CUT = dict(num_blocks=2, block_repeat=2, width_scale=0.125,
           batch_size_per_gpu=B)


def _batch():
    """Variable, odd lengths; labels short enough to be feasible."""
    rng = np.random.RandomState(0)
    return {"source_tensors": [rng.randn(B, T, FEATURES).astype(np.float32),
                               np.array([T, 37, 29, 23], np.int32)],
            "target_tensors": [rng.randint(0, VOCAB - 1, (B, L))
                               .astype(np.int32),
                               np.array([6, 3, 5, 1], np.int32)],
            "source_ids": np.arange(B, dtype=np.int32),
            "batch_valid": np.int32(B)}


def _both(dtype):
    """(JAX model, its eval output, port model, its eval output) on the
    same weights and batch."""
    batch = _batch()
    jmodel = JaxSpeech2Text(jax_jasper_params(
        SyntheticSpeechDataLayer, DATA, dtype=dtype, **CUT), mode="eval")
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=1)
    jstate = jstate.replace(params=variables["params"],
                            model_state={"batch_stats":
                                         variables["batch_stats"]})
    jout = jax.device_get(jax.jit(jmodel.eval_step)(jstate, batch))

    model = Speech2Text(jasper_model_params(
        SyntheticSpeechDataLayer, DATA, dtype=dtype, **CUT),
            mode="eval", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    out = to_host(model.eval_step(state, batch))
    return batch, jmodel, jout, model, out


def test_eval_step_matches_jax_fp32():
    batch, jmodel, jout, model, out = _both("float32")
    jdec, dec = jout["outputs"]["decoder_output"], out["outputs"][
        "decoder_output"]
    np.testing.assert_array_equal(dec["src_length"], jdec["src_length"])
    np.testing.assert_allclose(dec["logits"], jdec["logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["loss"], jout["loss"],
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(dec["outputs"], jdec["outputs"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    wer = model.finalize_evaluation([model.evaluate(batch, out)])
    jwer = jmodel.finalize_evaluation([jmodel.evaluate(batch, jout)])
    assert wer["Eval WER"] == jwer["Eval WER"]


def test_eval_step_matches_jax_mixed_logits():
    _, _, jout, _, out = _both("mixed")
    np.testing.assert_allclose(
        out["outputs"]["decoder_output"]["logits"],
        np.asarray(jout["outputs"]["decoder_output"]["logits"]),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("key,value", [
    ("prng_impl", "threefry"), ("dropout_bits", 32), ("remat", True),
    ("dropout_remat", True), ("num_model_partitions", 1),
    ("num_data_partitions", 0), ("fused_rnn", True)])
def test_schema_accepts_documented_no_ops(key, value):
    model = Speech2Text(jasper_model_params(
        SyntheticSpeechDataLayer, DATA, dtype="float32", **CUT,
        **{key: value}), mode="eval", device="cpu")
    assert model.params[key] == value


@pytest.mark.parametrize("key,value", [
    ("shard_params", True), ("use_xla_jit", True),
    ("num_pipeline_stages", 2), ("num_gpus", 8)])
def test_schema_refuses_keys_without_effect(key, value):
    with pytest.raises(ValueError, match=key):
        Speech2Text(jasper_model_params(
            SyntheticSpeechDataLayer, DATA, dtype="float32", **CUT,
            **{key: value}), mode="eval", device="cpu")


@pytest.fixture
def tiny_logdir(tmp_path):
    """A tiny port config and a seeded-init checkpoint of it."""
    config = tmp_path / "jasper_tiny.py"
    config.write_text(
        "from openseq2seq_tpu_torch.data import SyntheticSpeechDataLayer\n"
        "from openseq2seq_tpu_torch.models import Speech2Text\n"
        "from openseq2seq_tpu_torch.zoo import jasper_model_params\n"
        "base_model = Speech2Text\n"
        "base_params = jasper_model_params(SyntheticSpeechDataLayer, {!r},\n"
        "    dtype='float32', num_blocks=2, block_repeat=2,\n"
        "    width_scale=0.125, batch_size_per_gpu={}, logdir='')\n"
        .format(DATA, B))
    logdir = tmp_path / "logs"
    model = Speech2Text(jasper_model_params(
        SyntheticSpeechDataLayer, DATA, dtype="float32", **CUT),
            mode="eval", device="cpu")
    CheckpointManager(str(logdir)).save(trainer.restore_state(model), 0)
    return str(config), str(logdir)


def test_run_main_eval_and_infer(tiny_logdir, tmp_path):
    config, logdir = tiny_logdir
    args = ["--config_file=" + config, "--logdir=" + logdir, "--device=cpu"]
    launches = ctc_cuda.LAUNCHES
    metrics = run.main(args + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and metrics["eval_loss"] > 0
    assert 0.0 <= metrics["Eval WER"]
    assert ctc_cuda.LAUNCHES == launches      # CPU tensors: plain version

    out_csv = str(tmp_path / "infer.csv")
    run.main(args + ["--mode=infer", "--infer_output_file=" + out_csv])
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["wav_filename", "predicted_transcript"]
    assert len(rows) == 1 + DATA["num_batches"] * B


def test_run_main_refuses_train(tiny_logdir):
    """Training refuses a logdir that holds a checkpoint unless told to
    continue from it, and a config that sets neither max_steps nor
    num_epochs; neither leaves a logdir behind."""
    config, logdir = tiny_logdir
    with pytest.raises(OSError, match="continue_learning"):
        run.main(["--config_file=" + config, "--logdir=" + logdir,
                  "--mode=train", "--device=cpu"])
    with pytest.raises(ValueError, match="max_steps"):
        run.main(["--config_file=" + config, "--logdir=" + logdir + "_new",
                  "--mode=train", "--device=cpu"])
    assert not os.path.exists(logdir + "_new")
