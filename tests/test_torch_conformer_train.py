"""The port's Conformer training against the JAX package's: the tiny fp32
config of ``example_configs_torch/speech2text/conformer_tiny_synthetic.py``
(two blocks of width 128) with its AdamW, ``transformer_policy`` and
``max_grad_norm``, dropout off, from the same weights and batch: the
port's seeded weights with random norms and biases, converted (which
spares the JAX side its ``init``), and ``test_torch_conformer.py``'s
batch. Three
``train_step``s on each side with both kernel flags on and both off: the
loss of each step, then every parameter after the third, compared leaf by
leaf through the inverse converter. With the flags on, the JAX side runs
its Pallas kernels in interpret mode (``FORCE_INTERPRET``, set for the
test and put back) and the port the kernels' plain versions, forward and
backward.

Then the dropout: its sites are the JAX module's (the same tensors, in
the same order, with the same keep probability), a run with dropout is
reproducible from its seed, and the port's ``run.main`` trains, resumes
and evaluates on the tiny config on the CPU.

Both sides train with the config's AdamW at an epsilon of 1e-4 in place
of its 1e-9: AdamW's first steps move each element by about lr g / (|g| +
eps), so with eps 1e-9 a gradient element that is zero up to rounding
(one in some 10^4 here) moves by a whole +-lr on either side at random;
at 1e-4 such an element moves by less than lr 1e-4 / |g| of rounding noise
and every other element as before (``test_torch_optimizers.py`` holds
AdamW itself against optax).

Tolerance: rtol 1e-4 and atol 1e-6 on losses and parameters, as
``test_torch_ds2_train.py``: fp32 sums in another order through two
blocks, then three AdamW steps."""
import os
import re
import runpy

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders import conformer_encoder as jce
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.models.model import TrainState as JaxTrainState
from openseq2seq_tpu.ops import conformer_pallas, flash_relpos
from openseq2seq_tpu.parts import dropout as jdropout
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders import conformer_encoder as pce
from openseq2seq_tpu_torch.ops import conformer_conv, ctc_cuda
from openseq2seq_tpu_torch.ops import flash_relpos as port_flash_relpos
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_conformer import (FLAGS, TINY, _batch, _jax_params,
                                  _port_params, _randomize)
from test_torch_text_data import one_thread  # noqa: F401

STEPS = 3
RTOL, ATOL = 1e-4, 1e-6


def _train_params(params, keep=1.0):
    params = dict(params, max_steps=STEPS,
                  optimizer_params=dict(params["optimizer_params"],
                                        epsilon=1e-4))
    params["encoder_params"] = dict(params["encoder_params"],
                                    dropout_keep_prob=keep,
                                    attention_dropout_keep_prob=keep)
    return params


def _jax_train_params(flags, keep=1.0):
    port = _port_params(flags)
    return _train_params(dict(
        _jax_params(flags), optimizer=port["optimizer"],
        optimizer_params=port["optimizer_params"],
        lr_policy=port["lr_policy"], lr_policy_params=port["lr_policy_params"],
        max_grad_norm=port["max_grad_norm"]), keep)


@pytest.fixture(scope="module")
def variables():
    """The tiny config's seeded weights with random norm scales and
    biases, as a flax tree."""
    model = runpy.run_path(TINY)["base_model"](_port_params(), mode="eval",
                                               device="cpu")
    module = model.init_state(_batch()).module
    return _randomize(flax_from_state_dict(module.state_dict(),
                                           layer_norm_modules(module)),
                      seed=1)


def _assert_tree_close(got, want, path=""):
    assert set(got) == set(want), path
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_tree_close(got[key], value, path + "/" + key)
        else:
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(value), rtol=RTOL,
                                       atol=ATOL, err_msg=path + "/" + key)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_train_steps_match_jax(flags, variables, monkeypatch):
    batch = _batch()
    params = variables["params"]
    jmodel = JaxSpeech2Text(_jax_train_params(flags), mode="train")
    jstate = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                           params=params, model_state={},
                           opt_state=jmodel.optimizer().init(params),
                           loss_scale=None)
    if flags == "on":
        monkeypatch.setattr(flash_relpos, "FORCE_INTERPRET", True)
        monkeypatch.setattr(conformer_pallas, "FORCE_INTERPRET", True)
    step = jax.jit(jmodel.train_step)
    jlosses = []
    for i in range(STEPS):
        jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
        jlosses.append(float(metrics["loss"]))

    model = runpy.run_path(TINY)["base_model"](
        _train_params(_port_params(flags)), mode="train", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax({"params": params}))
    launches = (port_flash_relpos.LAUNCHES,
                port_flash_relpos.BWD_DQ_LAUNCHES,
                port_flash_relpos.BWD_DKV_LAUNCHES,
                conformer_conv.LAUNCHES, conformer_conv.BWD_LAUNCHES)
    losses = []
    for _ in range(STEPS):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    got = flax_from_state_dict(state.module.state_dict(),
                               layer_norm_modules(state.module))
    _assert_tree_close(got["params"], jax.device_get(jstate.params))
    # CPU tensors: the kernels' plain versions, no launch
    assert (port_flash_relpos.LAUNCHES, port_flash_relpos.BWD_DQ_LAUNCHES,
            port_flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
            conformer_conv.BWD_LAUNCHES) == launches


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_dropout_sites_match_jax(flags, variables, monkeypatch):
    """One training forward of the encoder, cut to one block, on each side
    with dropout on (keep 0.75, and 0.5 for the attention weights): the
    shapes of the dropped tensors and their keep probabilities, in order,
    are the JAX module's. The flash path drops no attention weights, on
    either side."""
    batch = _batch()
    if flags == "on":
        monkeypatch.setattr(flash_relpos, "FORCE_INTERPRET", True)
        monkeypatch.setattr(conformer_pallas, "FORCE_INTERPRET", True)
    want = []

    def record(rng, inputs, spec, *rest):
        want.append((tuple(inputs.shape), float(spec[2])))    # its keep
        return inputs
    monkeypatch.setattr(jdropout, "_mask_scale", record)
    monkeypatch.setattr(jdropout, "_mask_scale_remat", record)
    net = jce.ConformerNet(
        num_layers=1, hidden_size=128, num_heads=4, conv_kernel_size=7,
        ffn_expansion=4, subsampling_channels=32, dropout=0.25,
        attention_dropout=0.5, conv_norm="layer_norm", dtype_=jax.numpy.float32,
        fused_conv=flags == "on", flash_attention=flags == "on")
    feats, lengths = batch["source_tensors"]
    net_params = {k: v for k, v in variables["params"]["enc"]["net"].items()
                  if k != "block1"}
    net.apply({"params": net_params}, feats, lengths, True,
              rngs={"dropout": jax.random.PRNGKey(0)})

    got = []

    def port_dropout(x, keep_prob, generator, dropout_bits=32):
        got.append((tuple(x.shape), keep_prob))
        return x
    monkeypatch.setattr(pce, "dropout", port_dropout)
    params = _train_params(_port_params(flags), keep=0.75)
    params["encoder_params"]["attention_dropout_keep_prob"] = 0.5
    params["encoder_params"]["num_layers"] = 1
    model = runpy.run_path(TINY)["base_model"](params, mode="train",
                                               device="cpu")
    state = model.init_state(batch)
    with torch.no_grad():
        state.module.enc.net(torch.from_numpy(feats),
                             torch.from_numpy(lengths), True,
                             torch.Generator().manual_seed(0))
    assert got == want
    n_weights = sum(len(s) == 4 for s, _ in got)
    assert n_weights == (0 if flags == "on" else 1)
    assert len(got) == 1 + 6 + (flags == "off")


def _main(logdir, *extra):
    return run.main(["--config_file=" + TINY, "--logdir=" + logdir,
                     "--device=cpu", *extra])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_resumes_and_evaluates(tmp_path, capsys):
    """Dropout on: the loss falls over 10 steps, checkpoints at 5 and 10,
    ``--continue_learning`` resumes at 10, eval runs from the checkpoint;
    on the CPU no kernel launches."""
    logdir = str(tmp_path / "logs")
    launches = (port_flash_relpos.LAUNCHES,
                port_flash_relpos.BWD_DQ_LAUNCHES,
                port_flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
                conformer_conv.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
                ctc_cuda.BWD_LAUNCHES)
    result = _main(logdir, "--mode=train", "--max_steps=10",
                   "--print_loss_steps=1", "--save_checkpoint_steps=5")
    assert result["steps"] == 10
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["5", "10"]

    result = _main(logdir, "--mode=train", "--max_steps=12",
                   "--print_loss_steps=1", "--continue_learning")
    assert result["steps"] == 12
    out = capsys.readouterr().out
    assert "Starting training from step 10" in out
    assert len(_losses(out)) == 2

    metrics = _main(logdir, "--mode=eval")
    assert np.isfinite(metrics["eval_loss"])
    assert (port_flash_relpos.LAUNCHES, port_flash_relpos.BWD_DQ_LAUNCHES,
            port_flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
            conformer_conv.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
            ctc_cuda.BWD_LAUNCHES) == launches


def test_run_with_dropout_is_reproducible_from_its_seed(tmp_path):
    """3 straight steps, and 2 then 1 resumed from the checkpoint, give
    the same weights exactly (each step's generator is seeded from the
    run's seed and the step); another seed ends elsewhere."""
    def main(logdir, *extra):
        return run.main(["--config_file=" + TINY, "--device=cpu",
                         "--logdir=" + str(tmp_path / logdir),
                         "--mode=train", "--max_steps=3", *extra])

    def weights(logdir):
        return torch.load(str(tmp_path / logdir / "checkpoints" / "3" /
                              "model.pt"), map_location="cpu",
                          weights_only=True)["module"]

    main("straight", "--save_checkpoint_steps=1")
    main("split", "--max_steps=2", "--save_checkpoint_steps=1")
    main("split", "--continue_learning", "--save_checkpoint_steps=1")
    main("other", "--random_seed=1", "--save_checkpoint_steps=1")
    want = weights("straight")
    got = weights("split")
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    moved = weights("other")
    assert not all(torch.equal(moved[n], v) for n, v in want.items())
