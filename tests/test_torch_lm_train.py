"""The port's LSTM language model training against the JAX package's: the
tiny fp32 config of ``example_configs_torch/lm/lstm_lm_tiny_synthetic.py``
(two 128-unit LSTM layers, V 1000) with its dropouts off and
``num_sampled`` 0 (the full softmax: the two frameworks' candidate draws
differ), from the same converted weights and batch. Three Adam
``train_step``s with the config's ``max_grad_norm`` on each side, each
side carrying its own optimizer state: the loss of each step. Then each
of the three steps again from the JAX side's weights and Adam state
before it, carried over (``convert.optimizer_state_from_optax``): the
loss and the weights after it, leaf by leaf through the inverse
converter.

Adam divides each gradient element by its own size plus epsilon, so a
gradient's fp32 rounding error dg (sums in another order through 16
recurrent steps: up to about 2.4e-9 here, 1e-6 of the largest gradient)
moves an element's update by up to lr dg / (4 epsilon), where |g| is near
epsilon; over steps of its own, where a weight's gradients change sign,
its first moment nearly cancels and amplifies dg further. At the default
epsilon 1e-8 that is 3e-4, and 3 of the 65,536 recurrent weights of
layer 1 passed atol 1e-6 after one step from the same state (13 after
three steps each side on its own); at 1e-6 one weight of layer 2 still
did. So both sides take epsilon 1e-5 (bound 3e-7), and the weights are
held after each step from the carried state. The port runs
the fused recurrence (the LSTM kernels' plain versions, forward and
backward, on the CPU), the JAX side its scan; in fp32 the two compute the
same function.

Then the sampled softmax on: two runs from one seed give the same losses
and the loss falls; and the port's ``run.main`` in train (with the
dropouts and sampling on), eval (a perplexity), infer (one line of ids a
sequence) and ``--continue_learning``.

Tolerance: rtol 1e-4 and atol 1e-6 on losses and parameters, as
``test_torch_jasper_train.py``."""
import os
import re
import runpy

import jax
import numpy as np
import torch

from openseq2seq_tpu.models import LSTMLM as JaxLSTMLM
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           optimizer_state_from_optax,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.ops import lstm_scan
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_jasper_train import ATOL, RTOL, _assert_tree_close
from test_torch_lm import TINY, _batch, _jax_params, _port_params
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

STEPS = 3
# Adam's epsilon for the comparison (the config's default is 1e-8)
ADAM_EPS = 1e-5


def _train_params(sampled=0):
    params = _port_params(max_steps=STEPS, optimizer_params={
        "learning_rate": 5e-3, "epsilon": ADAM_EPS})
    params["encoder_params"].update(
        num_sampled=sampled, encoder_emb_keep_prob=1.0,
        encoder_dp_input_keep_prob=1.0, encoder_dp_output_keep_prob=1.0,
        encoder_last_output_keep_prob=1.0)
    return params


def _host_copy(jstate):
    """A numpy copy of a JAX train state (the step donates its buffers)."""
    return jax.tree_util.tree_map(np.array, jax.device_get(jstate))


def test_train_steps_match_jax():
    batch = _batch()
    model = runpy.run_path(TINY)["base_model"](_train_params(), mode="train",
                                               device="cpu")
    state = model.init_state(batch)
    variables = randomize(flax_from_state_dict(state.module.state_dict()),
                          seed=1)
    state.module.load_state_dict(state_dict_from_flax(variables))

    jmodel = JaxLSTMLM(_jax_params(_train_params()), mode="train")
    jstate = jmodel.init_state(batch)
    jstate = jstate.replace(params=variables["params"],
                            opt_state=jmodel.optimizer().init(
                                variables["params"]))
    step = jax.jit(jmodel.train_step)
    jlosses, jstates = [], [_host_copy(jstate)]
    for i in range(STEPS):
        jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
        jlosses.append(float(metrics["loss"]))

        jstates.append(_host_copy(jstate))

    losses = []
    for _ in range(STEPS):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]

    names = [n for n, _ in state.module.named_parameters()]
    for i in range(STEPS):
        before = jstates[i]
        state.module.load_state_dict(state_dict_from_flax(
            {"params": before.params}))
        state.opt_state = optimizer_state_from_optax(before.opt_state,
                                                     names)
        state.step = i
        state, metrics = model.train_step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), jlosses[i],
                                   rtol=RTOL, atol=ATOL)
        got = flax_from_state_dict(state.module.state_dict())
        _assert_tree_close(got["params"], jstates[i + 1].params,
                           "step {}".format(i + 1))


def test_sampled_training_is_reproducible_and_learns():
    """The sampled softmax (64 candidates a step, drawn from each step's
    generator): the same seed gives the same losses, and 12 steps on the
    repeated batch lower it."""
    def run_steps():
        params = _train_params(sampled=64)
        params["max_steps"] = 12
        model = runpy.run_path(TINY)["base_model"](params, mode="train",
                                                   device="cpu")
        batch = _batch()
        state = model.init_state(batch)
        generator = torch.Generator()
        losses = []
        for i in range(12):
            generator.manual_seed(i)
            state, metrics = model.train_step(state, batch, generator)
            losses.append(float(metrics["loss"]))
        return losses

    first, second = run_steps(), run_steps()
    assert first == second
    assert all(np.isfinite(first))
    assert np.mean(first[-3:]) < np.mean(first[:3]), first


def _main(logdir, *extra):
    return run.main(["--config_file=" + TINY, "--logdir=" + logdir,
                     "--device=cpu", *extra])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_evaluates_infers_and_resumes(tmp_path, capsys):
    """With the dropouts and sampling on: 8 steps with checkpoints at 4
    and 8, eval from the checkpoint (a perplexity), infer (one line of T
    ids a sequence), and ``--continue_learning`` resumes at 8; on the CPU
    no kernel launches."""
    logdir = str(tmp_path / "logs")
    launches = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
    result = _main(logdir, "--mode=train", "--max_steps=8",
                   "--print_loss_steps=1", "--save_checkpoint_steps=4")
    assert result["steps"] == 8
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["4", "8"]

    metrics = _main(logdir, "--mode=eval")
    out = capsys.readouterr().out
    assert "Validation perplexity" in out
    assert np.isclose(metrics["Eval perplexity"],
                      np.exp(metrics["eval_loss"]))

    infer_file = str(tmp_path / "infer.txt")
    _main(logdir, "--mode=infer", "--infer_output_file=" + infer_file)
    with open(infer_file) as f:
        lines = f.read().splitlines()
    params = _port_params()
    dl = params["data_layer_params"]
    assert len(lines) == dl["num_batches"] * params["batch_size_per_gpu"]
    rows = [[int(i) for i in line.split()] for line in lines]
    assert all(len(r) == dl["bptt"] and 0 <= min(r) and
               max(r) < dl["vocab_size"] for r in rows)

    result = _main(logdir, "--mode=train", "--max_steps=10",
                   "--print_loss_steps=1", "--continue_learning")
    assert result["steps"] == 10
    out = capsys.readouterr().out
    assert "Starting training from step 8" in out
    assert len(_losses(out)) == 2
    assert (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES) == launches
