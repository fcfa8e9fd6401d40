"""The port's ``Image2Label`` against the JAX package's: top-1 and top-5
over ``batch_valid``, ``finalize_evaluation``, ``infer`` and the
``sample_id,predicted_label`` csv on the same outputs; the whole tiny
ResNet and CNN classifiers (``FullyConnectedDecoder``'s flatten and its
``fully_connected`` layer included) through ``eval_step`` on converted
weights with random batch-norm statistics, fp32 within rtol 1e-5 and atol
1e-5 (logits, loss), "mixed" within 2^-6 of the logits' largest
magnitude, with the same top-1; the port's CLI on
``resnet_tiny_synthetic.py`` (train_eval, then infer from its
checkpoint); and, marked slow, the CIFAR toy: ``cifar10_nv.py``'s network
on ``test_utils/fake_cifar`` to an eval top-1 above 0.9, the JAX test's
criterion (``tests/test_image2label.py``)."""
import csv
import os
import runpy

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import \
    SyntheticImageDataLayer as JaxSynthetic
from openseq2seq_tpu.decoders import FullyConnectedDecoder as JaxFC
from openseq2seq_tpu.encoders import CNNEncoder as JaxCNN
from openseq2seq_tpu.encoders import ResNetEncoder as JaxResNet
from openseq2seq_tpu.losses import CrossEntropyLoss as JaxCE
from openseq2seq_tpu.models import Image2Label as JaxImage2Label
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import CNNEncoder
from openseq2seq_tpu_torch.models import Image2Label
from openseq2seq_tpu_torch.test_utils import fake_cifar
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "example_configs_torch", "image2label",
                    "resnet_tiny_synthetic.py")
CIFAR = os.path.join(REPO, "example_configs_torch", "image2label",
                     "cifar10_nv.py")
CNN_PARAMS = {
    "cnn_layers": [
        {"type": "conv2d", "filters": 8, "kernel_size": 3, "strides": 2,
         "activation": "relu"},
        {"type": "batch_norm"},
        {"type": "max_pool", "pool_size": 2},
    ],
    "fc_layers": [{"type": "dense", "units": 16, "activation": "relu"},
                  {"type": "dropout", "rate": 0.5}],
}


def _port_params(encoder, dtype):
    params = dict(runpy.run_path(TINY)["base_params"], dtype=dtype)
    if encoder == "cnn":
        params.update(encoder=CNNEncoder, encoder_params=CNN_PARAMS)
    return params


def _jax_params(encoder, dtype):
    params = dict(_port_params(encoder, dtype), decoder=JaxFC, loss=JaxCE,
                  data_layer=JaxSynthetic,
                  encoder=JaxCNN if encoder == "cnn" else JaxResNet)
    return params


def _outputs(logits, labels, valid):
    inputs = {"source_tensors": [np.zeros((len(labels), 2, 2, 3))],
              "target_tensors": [np.asarray(labels, np.int32)],
              "source_ids": np.arange(len(labels), dtype=np.int32) + 10,
              "batch_valid": np.int32(valid)}
    return inputs, {"outputs": {"decoder_output": {
        "logits": np.asarray(logits, np.float32)}}, "loss": 0.75}


def test_metrics_infer_and_csv_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    batches = [_outputs(rng.randn(8, 12), rng.randint(0, 12, 8), 8),
               _outputs(rng.randn(8, 12), rng.randint(0, 12, 8), 5)]
    port, jaxm = object.__new__(Image2Label), object.__new__(JaxImage2Label)
    results = []
    for model in (port, jaxm):
        evals = [model.evaluate(i, o) for i, o in batches]
        metrics = model.finalize_evaluation(evals)
        rows = [model.infer(i, o) for i, o in batches]
        path = str(tmp_path / "{}.csv".format(type(model).__module__))
        model.finalize_inference(rows, path)
        with open(path) as f:
            results.append((evals, metrics, rows, f.read()))
    assert results[0] == results[1]
    evals, metrics, rows, text = results[0]
    assert [e[2] for e in evals] == [8, 5]
    assert metrics["eval_loss"] == pytest.approx(0.75)
    assert sum(len(r) for r in rows) == 13
    lines = list(csv.reader(text.splitlines()))
    assert lines[0] == ["sample_id", "predicted_label"] and len(lines) == 14
    batch = {"source_tensors": [np.zeros((6, 4, 4, 3))]}
    assert port.get_num_objects_per_step(batch) == \
        jaxm._get_num_objects_per_step(batch) == 6


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("encoder", ["resnet", "cnn"])
def test_eval_step_matches_jax(encoder, dtype):
    jmodel = JaxImage2Label(_jax_params(encoder, dtype), mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=4)
    jstate = jstate.replace(params=variables["params"], model_state={
        "batch_stats": variables["batch_stats"]})
    jout = jax.device_get(jmodel.eval_step(jstate, batch))

    model = Image2Label(_port_params(encoder, dtype), mode="eval",
                        device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    out = to_host(model.eval_step(state, batch))
    want = np.asarray(jout["outputs"]["decoder_output"]["logits"],
                      np.float32)
    got = out["outputs"]["decoder_output"]["logits"]
    assert got.shape == want.shape == (4, 10)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["loss"], float(jout["loss"]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert state.module.dec.fully_connected.dtype == torch.bfloat16
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2.0 ** -6, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert model.evaluate(batch, out)[:3] == jmodel.evaluate(
        batch, jout)[:3]


def test_run_main_train_eval_and_infer(tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    result = run.main(["--config_file=" + TINY, "--mode=train_eval",
                       "--device=cpu", "--logdir=" + logdir,
                       "--max_steps=10", "--eval_steps=10"])
    printed = capsys.readouterr().out
    losses = [float(line.split("loss = ")[1].split(",")[0])
              for line in printed.splitlines() if "loss = " in line]
    assert result["steps"] == 10 and len(losses) == 2
    assert losses[-1] < losses[0]
    assert "Validation top-1" in printed
    out = str(tmp_path / "infer.csv")
    run.main(["--config_file=" + TINY, "--mode=infer", "--device=cpu",
              "--logdir=" + logdir, "--infer_output_file=" + out])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sample_id", "predicted_label"]
    assert len(rows) == 1 + 4 * 2
    assert all(0 <= int(r[1]) < 10 for r in rows[1:])


@pytest.mark.slow
def test_cifar_toy_reaches_top1(tmp_path, monkeypatch):
    data = fake_cifar.generate(str(tmp_path / "cifar"))
    monkeypatch.setenv("CIFAR10_DIR", data)
    logdir = str(tmp_path / "logs")
    # lr 0.003: the recipe's 0.05 diverges on the fake set, in the JAX
    # package too
    run.main(["--config_file=" + CIFAR, "--mode=train", "--device=cpu",
              "--logdir=" + logdir, "--num_epochs=5",
              "--optimizer_params/learning_rate=0.003"])
    metrics = run.main(["--config_file=" + CIFAR, "--mode=eval",
                        "--device=cpu", "--logdir=" + logdir])
    assert metrics["Eval top-1"] > 0.9, metrics
