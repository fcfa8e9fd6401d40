"""The port's Conformer-Transducer against the JAX package's, model level,
on the CPU in fp32: the tiny config of ``example_configs_torch/
speech2text/conformer_transducer_tiny_synthetic.py`` (two Conformer
blocks of width 64, prediction net and joint of width 32, V 8) built in
both packages, the port on the JAX model's weights carried by
``convert.py`` (random norms and biases, so that a wrong mapping shows):

  * ``eval_step``: the loss (lattice and fused) and the decode of one call,
    greedy ids exact, the beam's best ids exact and its n-best scores
    within 1e-4, and the WER that ``finalize_evaluation`` prints;
  * one AdamW ``train_step`` with the fused loss: the loss and every
    weight after it, leaf by leaf, and the AdamW moments carried by
    ``optimizer_state_from_optax`` (within rtol 1e-4 and 1e-5 of each
    tensor's largest element: a gradient's fp32 sums in another order);
    epsilon 1e-5 on both sides, as
    ``test_torch_lm_train.py`` sets it (AdamW moves an element whose
    gradient is zero up to rounding by a whole lr at epsilon 1e-9);
  * the prediction net's dropout sites in training, and a run with
    dropout reproducible from its seed;
  * ``run.main``: train, ``--continue_learning``, eval and infer (greedy
    and beam) on the tiny twin;
  * ``convert.py`` both ways against the JAX model's tree;
  * the full-width recipe's parameter count, the JAX model's;
  * marked ``slow``: the toy recipe to a loss below 1.0 and an eval WER
    below 0.1 after 150 epochs (``tests/test_transducer.py``'s bar).

Both kernel flags are off on both sides here (the JAX package's kernels
take no width of 64; ``test_torch_conformer*.py`` hold the flags on).
Tolerance: rtol 1e-4 and atol 1e-6 on losses and weights, as
``test_torch_jasper_train.py`` (fp32 sums in another order through two
blocks, then an AdamW step)."""
import copy
import csv
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu.decoders import TransducerDecoder as JaxDecoder
from openseq2seq_tpu.encoders import ConformerEncoder as JaxConformer
from openseq2seq_tpu.losses import TransducerLoss as JaxLoss
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.models.model import TrainState as JaxTrainState
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           optimizer_state_from_optax,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.decoders import transducer_decoder
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.models.model import _named_params
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_conformer import _randomize
from test_torch_jasper_train import ATOL, RTOL, _assert_tree_close
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "speech2text")
TINY = os.path.join(CONFIGS, "conformer_transducer_tiny_synthetic.py")
B, T, U = 4, 40, 6
ADAM_EPS = 1e-5
NBEST_ATOL = 1e-4


def _port_params(fused=False, beam=1, keep=1.0):
    params = copy.deepcopy(runpy.run_path(TINY)["base_params"])
    params["encoder_params"].update(flash_attention=False,
                                    fused_conv_module=False,
                                    dropout_keep_prob=1.0,
                                    attention_dropout_keep_prob=1.0)
    params["decoder_params"].update(fused_loss=fused, beam_width=beam,
                                    dropout_keep_prob=keep)
    params["optimizer_params"]["epsilon"] = ADAM_EPS
    return params


def _jax_params(params):
    return dict(copy.deepcopy(params), encoder=JaxConformer,
                decoder=JaxDecoder, loss=JaxLoss,
                data_layer=SyntheticSpeechDataLayer)


def _batch():
    """Frames 40, 33, 5 and 21 (10, 9, 2 and 6 after the subsampling),
    labels 6, 3, 4 and 0: a row whose labels outnumber its frames and a
    row with none."""
    rng = np.random.RandomState(0)
    return {"source_tensors": [rng.randn(B, T, 16).astype(np.float32),
                               np.array([40, 33, 5, 21], np.int32)],
            "target_tensors": [rng.randint(0, 7, (B, U)).astype(np.int32),
                               np.array([6, 3, 4, 0], np.int32)],
            "source_ids": np.arange(B, dtype=np.int32),
            "batch_valid": np.int32(B)}


@pytest.fixture(scope="module")
def variables():
    """The tiny config's seeded weights with random norm scales and
    biases, as a flax tree."""
    model = Speech2Text(_port_params(), mode="eval", device="cpu")
    module = model.init_state(_batch()).module
    return _randomize(flax_from_state_dict(module.state_dict(),
                                           layer_norm_modules(module)),
                      seed=1)


def _port_state(model, params):
    state = model.init_state(_batch())
    state.module.load_state_dict(state_dict_from_flax({"params": params}))
    return state


@pytest.mark.parametrize("decode", ["lattice", "fused", "beam"])
def test_eval_step_matches_jax(decode, variables):
    port_params = _port_params(fused=decode == "fused",
                               beam=4 if decode == "beam" else 1)
    batch = _batch()
    params = variables["params"]
    jmodel = JaxSpeech2Text(_jax_params(port_params), mode="eval")
    jstate = jmodel.init_state(batch).replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    jout = jax.device_get(jmodel.eval_step(jstate, batch))
    model = Speech2Text(port_params, mode="eval", device="cpu")
    out = to_host(model.eval_step(_port_state(model, params), batch))
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=RTOL)
    dec, jdec = (o["outputs"]["decoder_output"] for o in (out, jout))
    for got, want in zip(dec["outputs"], jdec["outputs"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    if decode == "beam":
        np.testing.assert_allclose(dec["nbest"][2], jdec["nbest"][2],
                                   rtol=0, atol=NBEST_ATOL)
    else:
        np.testing.assert_array_equal(dec["emit_frames"],
                                      jdec["emit_frames"])
    assert model.finalize_evaluation([model.evaluate(batch, out)]) == \
        pytest.approx(jmodel.finalize_evaluation(
            [jmodel.evaluate(batch, jout)]), rel=RTOL)


def _adam_state(state):
    """The Adam moments' dict in a (nested) optimizer state."""
    if isinstance(state, dict) and "mu" in state:
        return state
    for sub in state if isinstance(state, (list, tuple)) else ():
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def test_train_step_matches_jax(variables):
    """One AdamW step with the fused loss from the same weights."""
    batch = _batch()
    port_params = _port_params(fused=True)
    params = variables["params"]
    jmodel = JaxSpeech2Text(_jax_params(port_params), mode="train")
    jstate = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                           params=params, model_state={},
                           opt_state=jmodel.optimizer().init(params),
                           loss_scale=None)
    jstate, jmetrics = jax.jit(jmodel.train_step)(jstate, batch,
                                                  jax.random.PRNGKey(0))
    model = Speech2Text(port_params, mode="train", device="cpu")
    state = _port_state(model, params)
    state, metrics = model.train_step(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["global_grad_norm"]),
                               float(jmetrics["global_grad_norm"]),
                               rtol=RTOL)
    got = flax_from_state_dict(state.module.state_dict(),
                               layer_norm_modules(state.module))
    _assert_tree_close(got["params"], jax.device_get(jstate.params))
    # the JAX side's AdamW moments, carried into the port's state
    names = [n for n, _ in state.module.named_parameters()]
    carried = optimizer_state_from_optax(jax.device_get(jstate.opt_state),
                                         names)
    adam, ours = _adam_state(carried), _adam_state(state.opt_state)
    assert adam["count"] == ours["count"] == 1
    for key in ("mu", "nu"):
        for got_m, want_m in zip(ours[key], adam[key]):
            want_m = want_m.numpy()
            np.testing.assert_allclose(
                got_m.numpy(), want_m, rtol=RTOL,
                atol=1e-5 * float(np.abs(want_m).max(initial=0.0)))


def test_prediction_net_dropout_sites(variables, monkeypatch):
    """Training with the decoder's keep 0.5: one dropout a prediction-net
    layer, on its (B, U+1, H) outputs, at the model's mask width, as the
    JAX module's ``Dropout`` after each layer; none outside training."""
    calls = []

    def spy(x, keep_prob, generator, dropout_bits=32):
        calls.append((tuple(x.shape), keep_prob, dropout_bits))
        return x
    monkeypatch.setattr(transducer_decoder, "dropout", spy)
    params = _port_params(keep=0.5)
    params.update(dropout_bits=8)
    params["decoder_params"]["pred_layers"] = 2
    model = Speech2Text(params, mode="train", device="cpu")
    state = model.init_state(_batch())
    model.train_step(state, _batch(), torch.Generator().manual_seed(0))
    assert calls == [((B, U + 1, 32), 0.5, 8)] * 2
    model.eval_step(state, _batch())
    assert len(calls) == 2


def _main(logdir, *extra):
    return run.main(["--config_file=" + TINY, "--logdir=" + logdir,
                     "--device=cpu", *extra])


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_trains_resumes_evaluates_and_infers(tmp_path, capsys):
    """The loss falls over 10 steps with the config's dropout on,
    checkpoints at 5 and 10, ``--continue_learning`` resumes at 10 with
    the fused loss, eval prints a WER, infer writes one row an utterance
    greedily and with a beam of 4."""
    logdir = str(tmp_path / "logs")
    result = _main(logdir, "--mode=train", "--max_steps=10",
                   "--print_loss_steps=1", "--save_checkpoint_steps=5")
    assert result["steps"] == 10
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["5", "10"]

    result = _main(logdir, "--mode=train", "--max_steps=12",
                   "--print_loss_steps=1", "--continue_learning",
                   "--decoder_params/fused_loss=True")
    assert result["steps"] == 12
    out = capsys.readouterr().out
    assert "Starting training from step 10" in out
    assert len(_losses(out)) == 2

    metrics = _main(logdir, "--mode=eval")
    assert np.isfinite(metrics["eval_loss"])
    assert 0.0 <= metrics["Eval WER"]
    assert "Validation WER" in capsys.readouterr().out
    for beam in (1, 4):
        path = str(tmp_path / "infer_{}.csv".format(beam))
        _main(logdir, "--mode=infer", "--infer_output_file=" + path,
              "--decoder_params/beam_width={}".format(beam))
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["wav_filename", "predicted_transcript"]
        # two synthetic batches of the same 4 utterances
        assert [r[0] for r in rows[1:]] == [str(i // 2) for i in range(8)]


def test_run_with_dropout_is_reproducible_from_its_seed(tmp_path):
    """Two straight steps and one then one resumed give the same weights
    exactly, the prediction net's dropout on."""
    def main(logdir, *extra):
        return run.main(["--config_file=" + TINY, "--device=cpu",
                         "--logdir=" + str(tmp_path / logdir),
                         "--mode=train", "--max_steps=2",
                         "--save_checkpoint_steps=1",
                         "--decoder_params/dropout_keep_prob=0.5", *extra])

    def weights(logdir):
        return torch.load(str(tmp_path / logdir / "checkpoints" / "2" /
                              "model.pt"), map_location="cpu",
                          weights_only=True)["module"]

    main("straight")
    main("split", "--max_steps=1")
    main("split", "--continue_learning")
    want, got = weights("straight"), weights("split")
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def _jax_shapes(params, mode="train"):
    jmodel = JaxSpeech2Text(_jax_params(params), mode=mode)
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    return jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        batch, train=False))


def test_convert_round_trip():
    """The port's tree is the JAX model's, leaf for leaf and shape for
    shape (the transducer leaves by name), and back again."""
    params = _port_params(fused=True)
    model = Speech2Text(params, mode="train", device="cpu")
    module = model.init_state(_batch()).module
    sd = module.state_dict()
    tree = flax_from_state_dict(sd, layer_norm_modules(module))
    shapes = _jax_shapes(params)["params"]
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == \
        jax.tree_util.tree_map(lambda x: x.shape, dict(shapes))
    assert set(tree["params"]["dec"]) == {
        "pred_embedding", "pred_wx0", "pred_wh0", "pred_b0", "joint_enc_w",
        "joint_pred_w", "joint_b", "joint_out_w", "joint_out_b"}
    back = state_dict_from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    paths = ["/".join(p) for p, _ in _named_params(module)]
    assert "dec/pred_wx0" in paths and "dec/joint_out_b" in paths


def test_full_width_parameter_count():
    """``conformer_transducer_synthetic.py``: the port's parameter count is
    the JAX model's (by ``jax.eval_shape`` of its init), and
    ``chip_smoke.py`` holds the same number."""
    import chip_smoke
    params = copy.deepcopy(runpy.run_path(os.path.join(
        CONFIGS, "conformer_transducer_synthetic.py"))["base_params"])
    params["data_layer_params"].update(num_batches=1, time_steps=64,
                                       label_length=8)
    params["batch_size_per_gpu"] = 2
    params["max_steps"] = 1
    shapes = _jax_shapes(params)["params"]
    count = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    model = Speech2Text(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    module = model.build_module(batch, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in module.parameters()) == count == \
        chip_smoke.TRANSDUCER_PARAMS


@pytest.mark.slow
def test_toy_reaches_wer_below_0_1(tmp_path, monkeypatch, capsys):
    """``conformer_transducer_toy.py`` for 150 epochs (one step each): the
    last loss below 1.0 and the eval WER below 0.1."""
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    monkeypatch.setenv("OS2S_TOY_LOGDIR", str(tmp_path / "logs"))
    config = os.path.join(CONFIGS, "conformer_transducer_toy.py")
    result = run.main(["--config_file=" + config, "--device=cpu",
                       "--mode=train", "--num_epochs=150",
                       "--print_loss_steps=10"])
    assert float(result["last_metrics"]["loss"]) < 1.0
    metrics = run.main(["--config_file=" + config, "--device=cpu",
                        "--mode=eval"])
    assert metrics["Eval WER"] < 0.1, metrics


def test_profile_eval_transducer_arguments():
    """``scripts_torch/profile_eval.py``'s transducer profiles pick the
    full-width configs, and the beam from ``--beam-width``."""
    sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
    import profile_eval
    args = profile_eval.parse_args(["--train-transducer"])
    assert args.train and not args.infer and \
        args.config_file == profile_eval.TRANSDUCER_CONFIG
    args = profile_eval.parse_args(["--infer-transducer", "--beam-width=4"])
    assert args.infer and not args.train and args.beam_width == 4 and \
        args.config_file == profile_eval.TRANSDUCER_DECODE_CONFIG
    for path in (profile_eval.TRANSDUCER_CONFIG,
                 profile_eval.TRANSDUCER_DECODE_CONFIG):
        assert os.path.exists(path)
