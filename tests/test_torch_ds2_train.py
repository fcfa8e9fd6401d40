"""The port's DeepSpeech2 training against the JAX package's: the tiny
fp32 config of ``example_configs_torch/speech2text/ds2_tiny_synthetic.py``
(two 2-D convs, two bidirectional 128-unit layers), with GRU and with
LSTM cells, dropout keep 1.0, from the same converted weights
and batch (``test_torch_ds2.py``'s, with non-trivial batch-norm
statistics). Three ``train_step``s on each side: the loss of each step,
then the parameters and batch-norm statistics after the third, compared
leaf by leaf through the inverse converter. Then the port's ``run.main``
in train mode on that config on the CPU, with its dropout on.

The port runs the fused recurrence (``fused_rnn``: the scan kernels'
plain versions, forward and backward, on the CPU); the JAX side its
scan, whose gradients are exact where its Pallas LSTM backward is not
(C15, ``test_torch_rnn_train.py``); in fp32 the two paths compute the
same function.

Both sides train with Momentum (0.01, 0.9) in place of the config's
Adam, whose per-element normalization turns the rounding noise of a
near-zero gradient element into an update of up to the learning rate
(``test_torch_optimizers.py`` holds Adam against optax); and both freeze
the biases of the convs that feed a batch norm
(``freeze_variables_regex``): the norm removes them, so their gradient is
zero in exact arithmetic and rounding noise in either framework. The JAX
side starts from the port's seeded weights, converted, which spares its
``init``.

Tolerance: rtol 1e-4 and atol 1e-6 on losses, parameters and
statistics, as ``test_torch_jasper_train.py``."""
import os
import re
import runpy

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.models.model import TrainState as JaxTrainState
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.ops import ctc_cuda, gru_scan, lstm_scan
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_ds2 import TINY, _batch, _jax_params, _port_params
from test_torch_jasper_train import ATOL, RTOL, _assert_state_matches
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

STEPS = 3
FREEZE = r"/conv\d+/bias$"


def _train_params(params):
    params = dict(params, max_steps=STEPS, freeze_variables_regex=FREEZE,
                  optimizer="Momentum",
                  optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    params["encoder_params"] = dict(params["encoder_params"],
                                    dropout_keep_prob=1.0)
    return params


@pytest.mark.parametrize("rnn_type", ["cudnn_gru", "cudnn_lstm"])
def test_train_steps_match_jax(rnn_type):
    batch = _batch()
    model = runpy.run_path(TINY)["base_model"](
        _train_params(_port_params(rnn_type)), mode="train", device="cpu")
    state = model.init_state(batch)
    variables = randomize(flax_from_state_dict(state.module.state_dict()),
                          seed=1)
    state.module.load_state_dict(state_dict_from_flax(variables))

    jmodel = JaxSpeech2Text(_train_params(_jax_params(rnn_type)),
                            mode="train")
    jstate = JaxTrainState(
        step=jax.numpy.zeros((), jax.numpy.int32),
        params=variables["params"],
        model_state={"batch_stats": variables["batch_stats"]},
        opt_state=jmodel.optimizer().init(variables["params"]),
        loss_scale=None)
    step = jax.jit(jmodel.train_step)
    jlosses = []
    for i in range(STEPS):
        jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
        jlosses.append(float(metrics["loss"]))

    losses = []
    for _ in range(STEPS):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    _assert_state_matches(state, jstate)


def _main(logdir, *extra):
    return run.main(["--config_file=" + TINY, "--logdir=" + logdir,
                     "--device=cpu", *extra])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_resumes_and_evaluates(tmp_path, capsys):
    """Dropout on (keep 0.5): the loss falls over 8 steps, checkpoints at
    4 and 8, ``--continue_learning`` resumes at 8, eval runs from the
    checkpoint; on the CPU no kernel launches."""
    logdir = str(tmp_path / "logs")
    launches = (gru_scan.LAUNCHES, gru_scan.BWD_LAUNCHES,
                ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
    result = _main(logdir, "--mode=train", "--max_steps=8",
                   "--print_loss_steps=1", "--save_checkpoint_steps=4")
    assert result["steps"] == 8
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["4", "8"]

    result = _main(logdir, "--mode=train", "--max_steps=10",
                   "--print_loss_steps=1", "--continue_learning")
    assert result["steps"] == 10
    out = capsys.readouterr().out
    assert "Starting training from step 8" in out
    assert len(_losses(out)) == 2

    metrics = _main(logdir, "--mode=eval")
    assert np.isfinite(metrics["eval_loss"])
    assert (gru_scan.LAUNCHES, gru_scan.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
            ctc_cuda.BWD_LAUNCHES) == launches


def test_run_with_dropout_is_reproducible_from_its_seed(tmp_path):
    """3 straight steps, and 2 then 1 resumed from the checkpoint, give
    the same weights and statistics exactly (each step's generator is
    seeded from the run's seed and the step); another seed ends
    elsewhere. LSTM cells, so that both plain backward versions train."""
    config = tmp_path / "ds2_tiny_lstm.py"
    config.write_text(
        "import runpy\n_c = runpy.run_path({!r})\n"
        "base_model = _c['base_model']\n"
        "base_params = _c['base_params']\n"
        "base_params['encoder_params'] = dict(\n"
        "    base_params['encoder_params'], rnn_type='cudnn_lstm')\n"
        .format(TINY))

    def main(logdir, *extra):
        return run.main(["--config_file=" + str(config), "--device=cpu",
                         "--logdir=" + str(tmp_path / logdir),
                         "--mode=train", "--max_steps=3", *extra])

    def weights(logdir):
        return torch.load(str(tmp_path / logdir / "checkpoints" / "3" /
                              "model.pt"), map_location="cpu",
                          weights_only=True)["module"]

    main("straight")
    main("split", "--max_steps=2")
    main("split", "--continue_learning")
    main("other", "--random_seed=1")
    want = weights("straight")
    got = weights("split")
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    moved = weights("other")
    assert not all(torch.equal(moved[n], v) for n, v in want.items())
    assert lstm_scan.BWD_LAUNCHES == 0
