"""The port's training slice against the JAX package's: Speech2Text on
Jasper (cut to 2 blocks x 2 sub-layers, 1/8 width), fp32, every dropout
keep probability 1.0, NovoGrad + LARC + poly_decay as the zoo sets them,
from the same converted weights and batch as test_torch_jasper_slice.py.
Three ``train_step``s on each side: the loss of each step, then the
parameters and batch-norm statistics after the third, compared leaf by
leaf through the inverse converter. A port run also continues from the
JAX optimizer state after two JAX steps. Then the port's ``run.main`` in
train modes on a tiny config on the CPU.

On the CPU the JAX side's ``use_pallas`` takes its XLA scan (its
gradient is autodiff through the scan); test_torch_ctc_grad.py holds the
port's CTC gradient against the Pallas backward in interpret mode.

Both sides freeze the biases of the convs that feed a batch norm
(``freeze_variables_regex``, which this also holds against the JAX
package's): the norm removes them, so their gradient is zero in exact
arithmetic and is rounding noise in either framework, and NovoGrad's
per-tensor normalization scales that noise to a full-size update; the
batch-norm statistics would then carry it.

Tolerance: rtol 1e-4 and atol 1e-6 on losses, parameters and
statistics."""
import os
import re

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.zoo import jasper_model_params as jax_jasper_params
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           optimizer_state_from_optax,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.training import CheckpointManager
from openseq2seq_tpu_torch.zoo import jasper_model_params
from test_torch_jasper_slice import CUT, DATA, _batch
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6
STEPS = 3
FREEZE = r"/(conv|res)\d+_\d+/bias$"


def _no_dropout(params):
    params["freeze_variables_regex"] = FREEZE
    enc = params["encoder_params"]
    enc["dropout_keep_prob"] = 1.0
    for layer in enc["convnet_layers"]:
        layer["dropout_keep_prob"] = 1.0
    return params


def _models():
    jmodel = JaxSpeech2Text(_no_dropout(jax_jasper_params(
        SyntheticSpeechDataLayer, DATA, dtype="float32", max_steps=STEPS,
        **CUT)), mode="train")
    model = Speech2Text(_no_dropout(jasper_model_params(
        SyntheticSpeechDataLayer, DATA, dtype="float32", max_steps=STEPS,
        **CUT)), mode="train", device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side: the randomized initial variables, the state and loss
    after each of STEPS steps."""
    batch = _batch()
    jmodel, _ = _models()
    jstate = jmodel.init_state(batch)
    variables = randomize({"params": jstate.params,
                           "batch_stats": jstate.model_state["batch_stats"]},
                          seed=1)
    jstate = jstate.replace(
        params=variables["params"],
        model_state={"batch_stats": variables["batch_stats"]},
        opt_state=jmodel.optimizer().init(variables["params"]))
    step = jax.jit(jmodel.train_step)
    states, losses = [], []
    for i in range(STEPS):
        jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
        states.append(jstate)
        losses.append(float(metrics["loss"]))
    return variables, states, losses


def _assert_tree_close(got, want, where=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_close(got[k], v, where + "/" + k)
        else:
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=RTOL,
                                       atol=ATOL, err_msg=where + "/" + k)


def _assert_state_matches(state, jstate):
    got = flax_from_state_dict(state.module.state_dict())
    _assert_tree_close(got["params"], jax.device_get(jstate.params))
    _assert_tree_close(got["batch_stats"],
                       jax.device_get(jstate.model_state["batch_stats"]))


def test_train_steps_match_jax(jax_run):
    variables, jstates, jlosses = jax_run
    batch = _batch()
    _, model = _models()
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables))
    losses = []
    for _ in range(STEPS):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    assert state.step == STEPS
    _assert_state_matches(state, jstates[-1])


def test_train_continues_from_jax_optimizer_state(jax_run):
    _, jstates, jlosses = jax_run
    jstate = jax.device_get(jstates[-2])
    _, model = _models()
    state = model.init_state(_batch())
    state.module.load_state_dict(state_dict_from_flax(
        {"params": jstate.params,
         "batch_stats": jstate.model_state["batch_stats"]}))
    names = [n for n, _ in state.module.named_parameters()]
    state.opt_state = optimizer_state_from_optax(jstate.opt_state, names)
    state.step = STEPS - 1
    state, metrics = model.train_step(state, _batch())
    np.testing.assert_allclose(float(metrics["loss"]), jlosses[-1],
                               rtol=RTOL, atol=ATOL)
    _assert_state_matches(state, jstates[-1])


def test_mixed_fp16_loss_scaling_skips_overflowed_steps():
    """``mixed_fp16`` with the Backoff scaler (window 2, scale 4): a step
    whose input holds an inf overflows, so its gradients are zeroed (the
    optimizer still applies weight decay, as in the JAX package) and the
    scale halves; two clean steps later it doubles again. A clean step's
    loss is the fp32 model's within fp16 rounding."""
    def model(dtype, **extra):
        return Speech2Text(_no_dropout(jasper_model_params(
            SyntheticSpeechDataLayer, DATA, dtype=dtype, max_steps=4,
            **CUT, **extra)), mode="train", device="cpu")

    batch = _batch()
    bad = dict(batch, source_tensors=list(batch["source_tensors"]))
    bad["source_tensors"][0] = np.array(batch["source_tensors"][0])
    bad["source_tensors"][0][0, 0, 0] = np.inf
    m16 = model("mixed_fp16", loss_scaling="Backoff",
                loss_scaling_params={"scale_max": 4.0, "step_window": 2})
    state = m16.init_state(batch)
    m32 = model("float32")
    state32 = m32.init_state(batch)
    state32.module.load_state_dict(state.module.state_dict())
    _, want = m32.train_step(state32, batch)
    seen = []
    for b in (batch, bad, batch, batch):
        state, metrics = m16.train_step(state, b)
        seen.append((float(metrics["loss_scale"]),
                     int(metrics["skipped_update"]),
                     float(metrics["global_grad_norm"]) > 0))
        if len(seen) == 1:
            np.testing.assert_allclose(float(metrics["loss"]),
                                       float(want["loss"]), rtol=1e-2)
    assert seen == [(4.0, 0, True), (2.0, 1, False), (2.0, 0, True),
                    (4.0, 0, True)]


# ---------------------------------------------------------------------------
# run.main on a tiny config
# ---------------------------------------------------------------------------
@pytest.fixture
def tiny_config(tmp_path):
    """A tiny port config with dropout on (the zoo's keep probabilities,
    ``dropout_bits: 8``), printing the loss every step."""
    config = tmp_path / "jasper_tiny_train.py"
    config.write_text(
        "from openseq2seq_tpu_torch.data import SyntheticSpeechDataLayer\n"
        "from openseq2seq_tpu_torch.models import Speech2Text\n"
        "from openseq2seq_tpu_torch.zoo import jasper_model_params\n"
        "base_model = Speech2Text\n"
        "base_params = jasper_model_params(SyntheticSpeechDataLayer, {!r},\n"
        "    dtype='float32', num_blocks=2, block_repeat=2,\n"
        "    width_scale=0.125, batch_size_per_gpu={}, logdir='',\n"
        "    max_steps=3, print_loss_steps=1, save_checkpoint_steps=10,\n"
        "    eval_steps=10, load_model='')\n".format(
            DATA, CUT["batch_size_per_gpu"]))
    return str(config)


def _main(config, logdir, *extra):
    return run.main(["--config_file=" + config, "--logdir=" + logdir,
                     "--device=cpu", *extra])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_train_writes_checkpoints_and_loss_falls(tiny_config,
                                                          tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    result = _main(tiny_config, logdir, "--mode=train", "--max_steps=30")
    assert result["steps"] == 30
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["10", "20", "30"]

    # --continue_learning resumes at the saved step
    result = _main(tiny_config, logdir, "--mode=train", "--max_steps=32",
                   "--continue_learning")
    assert result["steps"] == 32
    out = capsys.readouterr().out
    assert "Starting training from step 30" in out
    assert len(_losses(out)) == 2

    # a logdir that holds a checkpoint is refused without it
    with pytest.raises(OSError, match="continue_learning"):
        _main(tiny_config, logdir, "--mode=train")


def test_run_main_resumed_run_equals_straight_run(tiny_config, tmp_path):
    """2 steps, then 1 resumed from the checkpoint, with dropout on: the
    per-step generator gives the weights of 3 straight steps, exactly."""
    straight = str(tmp_path / "straight")
    split = str(tmp_path / "split")
    _main(tiny_config, straight, "--mode=train")
    _main(tiny_config, split, "--mode=train", "--max_steps=2")
    _main(tiny_config, split, "--mode=train", "--continue_learning")
    device = torch.device("cpu")
    want = torch.load(os.path.join(straight, "checkpoints", "3", "model.pt"),
                      map_location=device, weights_only=True)
    got = torch.load(os.path.join(split, "checkpoints", "3", "model.pt"),
                     map_location=device, weights_only=True)
    assert got["step"] == want["step"] == 3
    for name, value in want["module"].items():
        assert torch.equal(got["module"][name], value), name
    # and the dropout draws do differ from step to step: a run with
    # another seed ends elsewhere
    other = str(tmp_path / "other")
    _main(tiny_config, other, "--mode=train", "--random_seed=1")
    moved = torch.load(os.path.join(other, "checkpoints", "3", "model.pt"),
                       map_location=device, weights_only=True)
    assert not all(torch.equal(moved["module"][n], v)
                   for n, v in want["module"].items())


def test_run_main_train_eval_prints_wer_and_saves_best(tiny_config, tmp_path,
                                                       capsys):
    logdir = str(tmp_path / "logs")
    _main(tiny_config, logdir, "--mode=train_eval", "--max_steps=10")
    out = capsys.readouterr().out
    assert re.search(r"Validation WER: [0-9.]+", out)
    assert os.listdir(os.path.join(logdir, "best_models")) and \
        "best_loss.txt" in os.listdir(os.path.join(logdir, "best_models"))
    metrics = _main(tiny_config, logdir, "--mode=eval")
    assert np.isfinite(metrics["eval_loss"])


def test_load_model_copies_weights_into_a_fresh_run(tiny_config, tmp_path):
    src = str(tmp_path / "src")
    _main(tiny_config, src, "--mode=train")
    dst = str(tmp_path / "dst")
    result = _main(tiny_config, dst, "--mode=train", "--max_steps=1",
                   "--load_model=" + src)
    assert result["steps"] == 1
    # restore_params_partial copies the parameters, not the statistics
    model = Speech2Text(jasper_model_params(
        SyntheticSpeechDataLayer, DATA, dtype="float32", **CUT),
            mode="eval", device="cpu")
    from openseq2seq_tpu_torch.training import trainer
    state = trainer.restore_state(model)
    before = {n: p.clone() for n, p in state.module.named_parameters()}
    CheckpointManager.restore_params_partial(
        os.path.join(src, "checkpoints", "3"), state.module)
    saved = torch.load(os.path.join(src, "checkpoints", "3", "model.pt"),
                       weights_only=True)["module"]
    for name, p in state.module.named_parameters():
        assert torch.equal(p, saved[name]) and not torch.equal(
            p, before[name]), name


def test_run_main_benchmark_times_the_steps_and_saves_nothing(tmp_path):
    """``--benchmark`` on the example tiny config."""
    logdir = str(tmp_path / "logs")
    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example_configs_torch", "speech2text",
        "jasper_tiny_synthetic.py")
    result = _main(config, logdir, "--mode=train", "--benchmark",
                   "--bench_steps=4", "--bench_start=2")
    assert result["steps"] == 4 and result["objects_per_sec"] > 0
    assert not os.path.exists(os.path.join(logdir, "checkpoints"))
