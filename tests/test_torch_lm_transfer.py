"""Classification transfer and generation of the port's LSTM LM against
the JAX package's, on converted weights and seeded numpy inputs: the
classification head (the last valid h, with and without the last layer's
c, with and without a ReLU layer of ``fc_dim``; LSTM and GRU cells), its
logits and every gradient of ``CrossEntropyLoss``; the loss itself on
integer and one-hot labels; the tiny IMDB recipe
(``example_configs_torch/transfer/imdb_tiny.py``) through ``eval_step``
to "Validation accuracy"; the partial restore of an LM checkpoint into
the classifier (``load_model``); ``LSTMLM.generate``'s greedy ids, and
its temperature sampling held for determinism under ``rng_seed`` and for
its law.

Tolerance: fp32, rtol 1e-5 and atol 1e-6 on logits, losses and
gradients (a few dozen terms a sum, in another order); accuracies and
greedy words exact; the sampled words' frequencies within 4 standard
deviations of the softmax's probabilities."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openseq2seq_tpu.data.lm import IMDBDataLayer as JaxIMDB
from openseq2seq_tpu.data.lm import WKTDataLayer as JaxWKT
from openseq2seq_tpu.decoders import FakeDecoder as JaxFakeDecoder
from openseq2seq_tpu.encoders import LMEncoder as JaxLMEncoder
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu.losses import CrossEntropyLoss as JaxCrossEntropy
from openseq2seq_tpu.models import LSTMLM as JaxLSTMLM
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.training import CheckpointManager, trainer
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMDB_TINY = os.path.join(REPO, "example_configs_torch", "transfer",
                         "imdb_tiny.py")
LM_TOY = os.path.join(REPO, "example_configs_torch", "lm", "lstm_toy.py")
B, T, V = 6, 10, 40
LENGTHS = np.array([10, 3, 1, 7, 10, 5], np.int32)
TOL = dict(rtol=1e-5, atol=1e-6)


def _head_params(cell, use_cell_state, fc_dim):
    return {"vocab_size": V, "emb_size": 12, "encoder_layers": 2,
            "encoder_use_skip_connections": False, "core_cell": None,
            "core_cell_params": {"num_units": 16}, "end_token": 1,
            "batch_size": B, "use_cudnn_rnn": False,
            "cudnn_rnn_type": "cudnn_gru" if cell == "gru" else None,
            "weight_tied": True, "lm_mode": False, "num_classes": 3,
            "use_cell_state": use_cell_state, "fc_dim": fc_dim,
            "dtype": "float32"}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("use_cell_state,fc_dim", [
    (False, 0), (True, 0), (False, 8), (True, 8)])
def test_classification_head_matches_jax(cell, use_cell_state, fc_dim):
    params = _head_params(cell, use_cell_state, fc_dim)
    jenc = JaxLMEncoder(dict(params), model=None, mode="train").make_module()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    labels = rng.randint(0, 3, (B,)).astype(np.int32)
    inputs = {"source_tensors": [jnp.asarray(ids), jnp.asarray(LENGTHS)]}
    variables = randomize(dict(jenc.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        inputs, train=False)), seed=2)
    assert "softmax" not in variables["params"]["net"]
    jloss_obj = JaxCrossEntropy({}, None)

    def jloss(p):
        out = jenc.apply({"params": p}, inputs, train=False)
        return jloss_obj.compute_loss({"decoder_output": out,
                                       "target_tensors": [labels]}), out
    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    enc = LMEncoder(dict(params), None, mode="train").make_module(
        0, torch.Generator().manual_seed(0))
    enc.load_state_dict(state_dict_from_flax(variables))
    out = enc({"source_tensors": [torch.from_numpy(ids),
                                  torch.from_numpy(LENGTHS)]}, False)
    assert out["logits"].shape == (B, 3) and \
        out["logits"].dtype == torch.float32
    loss = CrossEntropyLoss({}, None).compute_loss(
        {"decoder_output": out, "target_tensors": [torch.from_numpy(labels)]})
    loss.backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(out["outputs"].detach().numpy(),
                               np.asarray(jout["outputs"]), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = state_dict_from_flax({"params": jgrads})
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("one_hot", [False, True])
def test_cross_entropy_loss_matches_jax(one_hot):
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(B, 5)).astype(np.float32)
    labels = rng.randint(0, 5, (B,)).astype(np.int32)
    if one_hot:
        labels = np.eye(5, dtype=np.float32)[labels] * 0.9 + 0.02
    want = JaxCrossEntropy({}, None).compute_loss(
        {"decoder_output": {"logits": jnp.asarray(logits)},
         "target_tensors": [jnp.asarray(labels)]})
    got = CrossEntropyLoss({}, None).compute_loss(
        {"decoder_output": {"logits": torch.from_numpy(logits)},
         "target_tensors": [torch.from_numpy(labels)]})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if not one_hot:
        np.testing.assert_allclose(
            float(got), float(optax.softmax_cross_entropy_with_integer_labels(
                jnp.asarray(logits), jnp.asarray(labels)).mean()), rtol=1e-6)


@pytest.fixture(scope="module")
def imdb_tiny(tmp_path_factory):
    """The tiny IMDB recipe on its own corpus directory."""
    root = str(tmp_path_factory.mktemp("tiny_transfer"))
    os.environ["OS2S_TINY_TRANSFER_DIR"] = root
    try:
        return runpy.run_path(IMDB_TINY)
    finally:
        del os.environ["OS2S_TINY_TRANSFER_DIR"]


def _jax_cls_params(params):
    return dict(params, encoder=JaxLMEncoder, decoder=JaxFakeDecoder,
                loss=JaxCrossEntropy, data_layer=JaxIMDB)


def test_imdb_tiny_eval_matches_jax(imdb_tiny):
    """eval_step, evaluate and "Validation accuracy" of the tiny recipe
    from the same weights; infer writes one class a review."""
    params = dict(imdb_tiny["base_params"],
                  data_layer_params=dict(
                      imdb_tiny["base_params"]["data_layer_params"],
                      shuffle=False))
    jmodel = JaxLSTMLM(_jax_cls_params(dict(params)), mode="eval")
    batches = list(jmodel.get_data_layer().iterate_one_epoch())
    jstate = jmodel.init_state(batches[0])
    variables = {"params": jax.tree_util.tree_map(
        lambda a: (0.5 * np.random.RandomState(a.size).randn(*a.shape))
        .astype(np.float32), jax.device_get(jstate.params))}
    jstate = jstate.replace(params=variables["params"])
    model = imdb_tiny["base_model"](dict(params), mode="eval", device="cpu")
    state = model.init_state(batches[0])
    state.module.load_state_dict(state_dict_from_flax(variables))
    got_batches = list(model.get_data_layer().iterate_one_epoch())
    assert len(got_batches) == len(batches) == 8
    results, jresults = [], []
    for b, jb in zip(got_batches, batches):
        out = trainer.to_host(model.eval_step(state, b))
        jout = jax.device_get(jmodel.eval_step(jstate, jb))
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   rtol=1e-5)
        results.append(model.evaluate(b, out))
        jresults.append(jmodel.evaluate(jb, jout))
    assert results == jresults
    got = model.finalize_evaluation(results)
    assert got == jmodel.finalize_evaluation(jresults)
    assert set(got) == {"Eval accuracy", "eval_loss"}
    assert 0.0 < got["Eval accuracy"] < 1.0
    assert model.infer(got_batches[0], out)[0].shape == ()


def test_partial_restore_from_lm_checkpoint(imdb_tiny, tmp_path):
    """``load_model``: the classifier picks up the LM's embedding and LSTM
    weights by name and shape and leaves the LM's softmax; the head keeps
    the weights drawn from its seed."""
    root = os.path.dirname(os.path.dirname(
        imdb_tiny["base_params"]["lm_vocab_file"]))
    lm = runpy.run_path(LM_TOY)
    enc = dict(lm["base_params"]["encoder_params"])
    lm_params = dict(lm["base_params"], logdir=str(tmp_path / "lm"),
                     encoder_params=enc,
                     data_layer_params=dict(
                         lm["base_params"]["data_layer_params"],
                         data_root=root,
                         processed_data_folder=os.path.join(root,
                                                            "processed")))
    lm_model = lm["base_model"](lm_params, mode="eval", device="cpu")
    lm_state = trainer.restore_state(lm_model)
    with torch.no_grad():
        for p in lm_state.module.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())))
    CheckpointManager(str(tmp_path / "lm")).save(lm_state, 7)
    saved = {n: p.detach().clone()
             for n, p in lm_state.module.named_parameters()}
    base = dict(imdb_tiny["base_params"])
    base["encoder_params"] = dict(base["encoder_params"], emb_size=16,
                                  core_cell_params={"num_units": 32})
    fresh = imdb_tiny["base_model"](dict(base), mode="train", device="cpu")
    fresh_state = trainer.restore_state(fresh)
    model = imdb_tiny["base_model"](dict(base, load_model=str(tmp_path /
                                                               "lm")),
                                    mode="train", device="cpu")
    state = trainer.restore_state(model)
    restored = dict(state.module.named_parameters())
    fresh_params = dict(fresh_state.module.named_parameters())
    shared = [n for n in restored if n in saved]
    assert sorted(shared) == sorted(n for n in saved
                                    if ".softmax." not in n)
    assert any(".softmax." in n for n in saved)
    for n in shared:
        assert torch.equal(restored[n], saved[n]), n
    head = [n for n in restored if n not in saved]
    assert head and all(".classifier." in n or ".fc_hidden." in n
                        for n in head)
    for n in head:
        assert torch.equal(restored[n], fresh_params[n]), n


def _lm_pair(tmp_path):
    """The JAX and the port's LSTM LM of the toy recipe in eval, on the
    cycle corpus, with the same weights (every leaf 0.5 N(0, 1))."""
    lm = runpy.run_path(LM_TOY)
    params = dict(lm["base_params"], logdir="")
    params["encoder_params"] = dict(params["encoder_params"])
    params["data_layer_params"] = dict(
        params["data_layer_params"],
        processed_data_folder=str(tmp_path / "processed"))
    jmodel = JaxLSTMLM(dict(params, encoder=JaxLMEncoder,
                            decoder=JaxFakeDecoder, loss=JaxSequenceLoss,
                            data_layer=JaxWKT), mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    jstate = jmodel.init_state(batch)
    jparams = jax.tree_util.tree_map(
        lambda a: (0.5 * np.random.RandomState(a.size).randn(*a.shape))
        .astype(np.float32), jax.device_get(jstate.params))
    jstate = jstate.replace(params=jparams)
    model = lm["base_model"](params, mode="eval", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax({"params": jparams}))
    return jmodel, jstate, model, state


def test_generate_greedy_matches_jax(tmp_path):
    jmodel, jstate, model, state = _lm_pair(tmp_path)
    for seed in (["aa", "bb"], ["dd"], ["zz", "hh", "aa"]):
        want = jmodel.generate(jstate, seed_tokens=seed, num_tokens=12)
        got = model.generate(state, seed_tokens=seed, num_tokens=12)
        assert got == want
        assert len(got.split()) == len(seed) + 12
    assert len(set(got.split())) > 2


def test_generate_sampling_seeded_and_in_law(tmp_path):
    """Temperature sampling: the same ``rng_seed`` gives the same words,
    other seeds other words; the first sampled word's frequencies over
    600 seeds match the softmax of logits / temperature."""
    _, _, model, state = _lm_pair(tmp_path)
    a = model.generate(state, ["aa"], num_tokens=10, temperature=1.5,
                       rng_seed=4)
    assert a == model.generate(state, ["aa"], num_tokens=10,
                               temperature=1.5, rng_seed=4)
    assert any(model.generate(state, ["aa"], num_tokens=10,
                              temperature=1.5, rng_seed=s) != a
               for s in range(5, 8))
    w2i = model.get_data_layer().corp.word2idx
    with torch.no_grad():
        logits = state.module({"source_tensors": [
            torch.tensor([[w2i["aa"]] + [0] * 7], dtype=torch.int32),
            torch.tensor([8], dtype=torch.int32)]}, train=False)[
            "decoder_output"]["logits"][0, 0]
    probs = torch.softmax(logits / 1.5, dim=-1).numpy()
    n = 600
    counts = np.zeros(len(probs))
    for s in range(n):
        counts[w2i[model.generate(state, ["aa"], num_tokens=1,
                                  temperature=1.5, rng_seed=s).split()[1]]] \
            += 1
    sigma = np.sqrt(n * probs * (1 - probs))
    assert np.all(np.abs(counts - n * probs) <= 4 * sigma + 1), \
        (counts, n * probs)


def _toy_run(tmp_path, argv):
    from openseq2seq_tpu_torch import run
    os.environ["OS2S_TOY_LM_DIR"] = str(tmp_path / "data")
    try:
        return run.main(["--config_file=" + LM_TOY, "--device=cpu",
                         "--logdir=" + str(tmp_path / "logs")] + argv)
    finally:
        del os.environ["OS2S_TOY_LM_DIR"]


def test_lm_toy_short_run(tmp_path):
    """The toy recipe through ``run.main`` from text files: 2 epochs of
    training (a checkpoint, "Validation perplexity"), then eval and infer
    from the checkpoint (one line of 16 ids a track)."""
    result = _toy_run(tmp_path, ["--mode=train_eval", "--num_epochs=2"])
    assert result["steps"] == 16
    assert os.path.isdir(tmp_path / "logs" / "checkpoints" / "16")
    metrics = _toy_run(tmp_path, ["--mode=eval"])
    assert 1.0 < metrics["Eval perplexity"] < 11.0
    out = str(tmp_path / "infer.txt")
    _toy_run(tmp_path, ["--mode=infer", "--infer_output_file=" + out])
    rows = open(out).read().splitlines()
    assert len(rows) == 8 * 2 and all(len(r.split()) == 16 for r in rows[:8])


@pytest.mark.slow
def test_lm_toy_reaches_perplexity_below_2(tmp_path):
    """The LM family's toy run: the recipe's 30 epochs take the
    validation perplexity below 2.0 (``tests/test_lm.py``'s bar), and the
    trained LM continues the cycle."""
    _toy_run(tmp_path, ["--mode=train_eval"])
    metrics = _toy_run(tmp_path, ["--mode=eval"])
    assert metrics["Eval perplexity"] < 2.0, metrics
