"""The port's Centaur against the JAX package's, on the same inputs (from
numpy with fixed seeds) and converted weights (every leaf moved by N(0,
0.05^2), statistics made positive); its causal convolution is held in
``test_torch_causal_conv.py``:

  * the encoder in training (batch statistics, dropout off) and eval:
    outputs, the gradients of a weighted sum of them and the new
    statistics; "mixed" outputs;
  * the decoder under teacher forcing, every prenet mask set to keep
    (``jax.random.bernoulli`` patched on the JAX side, ``keep_mask`` on
    the port's), reduction 2, two heads: the outputs, the TTS loss, its
    gradients and the new statistics;
  * infer at ``infer_max_steps`` 12: frames, stop logits, alignments and
    lengths, free and with windowed forcing; one-hot alignments at window
    1 with one head;
  * C27: ``prenet_use_inference_dropout: False`` leaves the prenet's
    dropout on in infer on both sides; ``prenet_dropout``,
    ``attention_layers``, ``self_attention_conv_params`` and
    ``mag_conv_layers`` change nothing;
  * the converter's round trip, the full-width parameter count of
    ``centaur_synthetic.py`` by ``jax.eval_shape`` (and ``chip_smoke.py``'s
    copy of it);
  * ``run.main`` on the tiny config in train, eval and infer.

Tolerance: fp32 rtol 1e-5, atol 1e-5 on outputs; a gradient within 1e-5
of its leaf's largest magnitude plus rtol 1e-5, the biases of the convs
that feed a batch norm held to zero on both sides (the norm removes
them); "mixed" within 2^-5 of max(1, |value|), the JAX side op by op.
"""
import copy
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu import decoders as jax_decoders
from openseq2seq_tpu import encoders as jax_encoders
from openseq2seq_tpu import losses as jax_losses
from openseq2seq_tpu import models as jax_models
from openseq2seq_tpu.data.synthetic import \
    SyntheticTTSDataLayer as JaxSyntheticTTS
from openseq2seq_tpu_torch import decoders, encoders, losses, run
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.decoders.centaur_decoder import \
    CentaurDecoderModule
from openseq2seq_tpu_torch.models import Text2SpeechCentaur
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_convs2s import (_leaves_perturbed, assert_bf16_close,
                                assert_grads_close)
from test_torch_jasper_train import _assert_tree_close
# torch on one thread
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2speech")
TINY = os.path.join(CONFIGS, "centaur_tiny_synthetic.py")
B, S, T, F, V, E = 3, 10, 16, 6, 9, 20
SRC_LEN = np.array([10, 4, 7], np.int32)
SPEC_LEN = np.array([16, 9, 5], np.int32)
# the biases of the convs that feed a batch norm
PRE_NORM_BIAS = r"/conv[0-9]+/bias$"


def _perturbed_weights(module, seed):
    variables = _leaves_perturbed(flax_from_state_dict(module.state_dict()),
                                  seed)
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])
    module.load_state_dict(state_dict_from_flax(variables))
    return {k: v for k, v in variables.items() if v}


def _grads(module):
    """The gradients as a flax tree (the statistics name the norms)."""
    tree = {n: p.grad for n, p in module.named_parameters()}
    tree.update(module.named_buffers())
    return flax_from_state_dict(tree)["params"]


def _assert_grads_close(got, want):
    """The biases of ``PRE_NORM_BIAS`` held to zero on both sides, the
    rest as ``assert_grads_close``."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    scale = max(np.abs(np.asarray(v)).max() for _, v in flat)
    zero = {path for path, _ in flat
            if re.search(PRE_NORM_BIAS, "/" + "/".join(k.key for k in path))}
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path in zero:
        assert np.abs(got_flat[path]).max() <= 1e-5 * scale
        assert np.abs(np.asarray(dict(flat)[path])).max() <= 1e-5 * scale
    strip = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: np.zeros_like(v) if p in zero else v, tree)
    assert_grads_close(strip(got), strip(want))


def _stats(module):
    return flax_from_state_dict(module.state_dict())["batch_stats"]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _enc_params(**extra):
    conv = {"kernel_size": [3], "stride": [1], "padding": "SAME"}
    return dict({"src_vocab_size": V, "embedding_size": 16,
                 "output_size": E, "pad_embeddings_2_eight": True,
                 "cnn_dropout_prob": 0.0,
                 "conv_layers": [dict(conv, num_channels=12),
                                 dict(conv, num_channels=8,
                                      padding="CAUSAL")]}, **extra)


def _enc_inputs():
    ids = np.random.RandomState(0).randint(0, V, (B, S)).astype(np.int32)
    return ({"source_tensors": [jnp.asarray(ids), jnp.asarray(SRC_LEN)]},
            {"source_tensors": [torch.from_numpy(ids),
                                torch.from_numpy(SRC_LEN)]})


def test_encoder_matches_jax():
    params = _enc_params()
    jenc = jax_encoders.CentaurEncoder(params, None).make_module()
    enc = encoders.CentaurEncoder(params, None).make_module(
        0, torch.Generator().manual_seed(0))
    variables = _perturbed_weights(enc, 1)
    jin, tin = _enc_inputs()
    weights = np.random.RandomState(2).randn(B, S, E).astype(np.float32)

    @jax.jit
    def jax_run(v):
        def objective(p):
            out, new = jenc.apply({**v, "params": p}, jin, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)},
                                  mutable=["batch_stats"])
            return jnp.sum(out["outputs"] * weights), (out, new)
        (_, (out, new)), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        return out["outputs"], new["batch_stats"], g, jenc.apply(
            v, jin, train=False)["outputs"]

    want, want_stats, want_grads, want_eval = jax.device_get(
        jax_run(variables))
    state = copy.deepcopy(enc.state_dict())
    got = enc(tin, True, torch.Generator())
    np.testing.assert_allclose(got["outputs"].detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    (got["outputs"] * torch.from_numpy(weights)).sum().backward()
    _assert_grads_close(_grads(enc), want_grads)
    _assert_tree_close(_stats(enc), want_stats, "stats")
    enc.load_state_dict(state)
    with torch.no_grad():
        ev = enc(tin, False)
    np.testing.assert_allclose(ev["outputs"].numpy(), want_eval, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ev["src_length"].numpy(), SRC_LEN)


def test_encoder_mixed_matches_jax():
    params = _enc_params(dtype="mixed")
    jenc = jax_encoders.CentaurEncoder(params, None).make_module()
    enc = encoders.CentaurEncoder(params, None).make_module(
        0, torch.Generator().manual_seed(3))
    variables = _perturbed_weights(enc, 4)
    jin, tin = _enc_inputs()
    want = jenc.apply(variables, jin, train=False)["outputs"]
    with torch.no_grad():
        got = enc(tin, False)["outputs"]
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _conv(ch=32):
    return {"kernel_size": [3], "stride": [1], "num_channels": ch,
            "padding": "CAUSAL"}


def _dec_params(**extra):
    return dict({"prenet_layers": 2, "prenet_hidden_size": 12,
                 "hidden_size": 32, "conv_layers": [_conv()] * 3,
                 "mag_conv_layers": None, "attention_dropout": 0.0,
                 "layer_postprocess_dropout": 0.0, "cnn_dropout_prob": 0.0,
                 "attention_heads": 2, "reduction_factor": 2,
                 "num_audio_features": F, "infer_max_steps": 12}, **extra)


@pytest.fixture
def keep_all(monkeypatch):
    """Every prenet mask keeps, on both sides."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(CentaurDecoderModule, "keep_mask",
                        lambda self, shape, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))


def _dec_inputs():
    rng = np.random.RandomState(6)
    memory = rng.randn(B, S, E).astype(np.float32)
    spec = rng.randn(B, T, F).astype(np.float32)
    stop = (np.arange(T)[None, :] >= SPEC_LEN[:, None] - 1).astype(
        np.float32)
    return memory, [spec, stop, SPEC_LEN]


def _decoders(params, mode, seed):
    memory, targets = _dec_inputs()
    jdec = jax_decoders.CentaurDecoder(params, None, mode=mode).make_module()
    dec = decoders.CentaurDecoder(params, None, mode=mode).make_module(
        E, torch.Generator().manual_seed(0))
    variables = _perturbed_weights(dec, seed)
    jin = {"encoder_output": {"outputs": jnp.asarray(memory),
                              "src_length": jnp.asarray(SRC_LEN)}}
    tin = {"encoder_output": {"outputs": torch.from_numpy(memory),
                              "src_length": torch.from_numpy(SRC_LEN)}}
    if mode != "infer":
        jin["target_tensors"] = [jnp.asarray(t) for t in targets]
        tin["target_tensors"] = [torch.from_numpy(t) for t in targets]
    return jdec, variables, jin, dec, tin


OUTPUTS = ("decoder_spec", "post_net_spec", "stop_token_logits",
           "alignments")


def _assert_outputs_close(got, want):
    for key in OUTPUTS:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))


def test_decoder_teacher_forced_matches_jax(keep_all):
    """Training: the outputs, the L1 TTS loss, its gradients and the new
    batch statistics."""
    params = _dec_params()
    jdec, variables, jin, dec, tin = _decoders(params, "train", 7)
    jloss = jax_losses.Text2SpeechLoss({"l1_norm": True}, None)

    @jax.jit
    def jax_run(v):
        def objective(p):
            out, new = jdec.apply({**v, "params": p}, jin, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)},
                                  mutable=["batch_stats"])
            loss = jloss.compute_loss({
                "decoder_output": out,
                "target_tensors": jin["target_tensors"]})
            return loss, (out, new)
        (loss, (out, new)), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        return loss, out, new["batch_stats"], g

    want_loss, want, want_stats, want_grads = jax.device_get(
        jax_run(variables))
    got = dec(tin, True, torch.Generator())
    assert got["decoder_spec"].shape == (B, T, F)
    assert got["alignments"].shape == (B, T // 2, S)
    _assert_outputs_close(got, want)
    loss = losses.Text2SpeechLoss({"l1_norm": True}, None).compute_loss(
        {"decoder_output": got, "target_tensors": tin["target_tensors"]})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    _assert_tree_close(_stats(dec), want_stats, "stats")
    loss.backward()
    _assert_grads_close(_grads(dec), want_grads)


@pytest.mark.parametrize("extra", [
    {}, {"window_size": 3, "back_step_size": 1, "force_layers": [0, 2]}],
    ids=["free", "forced"])
def test_decoder_infer_matches_jax(extra, keep_all):
    """12 frames, 6 groups: the frames, stop logits, alignments and the
    lengths. The frame projection's kernel is scaled by 0.1 on both
    sides: at the perturbed weights each decoded frame feeds back larger
    (to about 700 by the sixth group), and there the JAX module's own
    ``jit`` and op-by-op runs differ by 3e-5 of the value; at 0.1 the
    frames stay under 1, and the two sides agree within a tenth of the
    tolerance."""
    params = _dec_params(**extra)
    jdec, variables, jin, dec, tin = _decoders(params, "infer", 8)
    variables["params"]["frame"]["kernel"] *= 0.1
    dec.load_state_dict(state_dict_from_flax(variables))
    want = jax.jit(lambda v: jdec.apply(
        v, jin, train=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables)
    with torch.no_grad():
        got = dec(tin, False, torch.Generator())
    assert got["decoder_spec"].shape == (B, 12, F)
    assert got["lengths"].min() >= 1
    assert len(set(got["lengths"].tolist())) == B
    _assert_outputs_close(got, want)


def test_window_of_one_gives_one_hot_alignments(keep_all):
    """``window_size`` 1, one head, every layer forced: each infer step
    attends to exactly one encoder position, on both sides; without
    forcing the attention is soft."""
    params = _dec_params(attention_heads=1, window_size=1)
    jdec, variables, jin, dec, tin = _decoders(params, "infer", 9)
    want = jax.jit(lambda v: jdec.apply(
        v, jin, train=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables)
    with torch.no_grad():
        got = dec(tin, False, torch.Generator())["alignments"].numpy()
    np.testing.assert_allclose(got, want["alignments"], rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.max(-1) > 0.999)
    free = decoders.CentaurDecoder(_dec_params(attention_heads=1), None,
                                   mode="infer").make_module(
        E, torch.Generator())
    free.load_state_dict(dec.state_dict())
    with torch.no_grad():
        soft = free(tin, False, torch.Generator())["alignments"].numpy()
    assert soft.max(-1).min() < 0.999


def test_c27_prenet_dropout_on_in_infer():
    """``prenet_use_inference_dropout: False`` (the recipe's) leaves the
    prenet's dropout on in infer: in the JAX module two dropout keys give
    two decodes, and in the port two generator seeds do."""
    params = _dec_params(prenet_use_inference_dropout=False,
                         prenet_dropout=0.1)
    jdec, variables, jin, dec, tin = _decoders(params, "infer", 10)
    run_jax = jax.jit(lambda v, k: jdec.apply(
        v, jin, train=False, rngs={"dropout": k})["decoder_spec"])
    assert not np.allclose(run_jax(variables, jax.random.PRNGKey(0)),
                           run_jax(variables, jax.random.PRNGKey(1)))
    with torch.no_grad():
        a, b = (dec(tin, False, torch.Generator().manual_seed(s))[
            "decoder_spec"] for s in (0, 1))
    assert not torch.equal(a, b)


def test_c27_keys_without_effect(keep_all):
    """``prenet_dropout``, ``attention_layers``,
    ``self_attention_conv_params`` and ``mag_conv_layers`` change nothing
    in the JAX module (the same outputs from the same weights) and nothing
    in the port."""
    base = _dec_params()
    extra = dict(base, prenet_dropout=0.9, attention_layers=7,
                 self_attention_conv_params=_conv(64),
                 mag_conv_layers=[_conv(64)] * 5)
    jdec, variables, jin, dec, tin = _decoders(base, "train", 11)
    jdec2 = jax_decoders.CentaurDecoder(extra, None, mode="train") \
        .make_module()
    dec2 = decoders.CentaurDecoder(extra, None, mode="train").make_module(
        E, torch.Generator())
    dec2.load_state_dict(dec.state_dict())
    run_jax = lambda m: jax.jit(lambda v: m.apply(  # noqa: E731
        v, jin, train=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables)
    want, want2 = run_jax(jdec), run_jax(jdec2)
    with torch.no_grad():
        got, got2 = dec(tin, False, torch.Generator()), \
            dec2(tin, False, torch.Generator())
    for key in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      np.asarray(want2[key]))
        torch.testing.assert_close(got[key], got2[key], rtol=0, atol=0)
    _assert_outputs_close(got, want)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def _tiny_params(**overrides):
    params = copy.deepcopy(runpy.run_path(TINY)["base_params"])
    params.update(overrides)
    return params


def _jax_shapes(params):
    jmodel = jax_models.Text2SpeechCentaur(dict(
        params, encoder=jax_encoders.CentaurEncoder,
        decoder=jax_decoders.CentaurDecoder, loss=jax_losses.Text2SpeechLoss,
        data_layer=JaxSyntheticTTS), mode="train")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    return jax.eval_shape(lambda: jmodel.module().init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        batch, train=False))


def test_convert_round_trip():
    params = _tiny_params()
    model = Text2SpeechCentaur(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    sd = model.init_state(batch).module.state_dict()
    tree = flax_from_state_dict(sd)
    shapes = _jax_shapes(params)
    for col in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, tree[col]) == \
            jax.tree_util.tree_map(lambda x: x.shape, dict(shapes[col]))
    back = state_dict_from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_full_width_parameter_count():
    """``centaur_synthetic.py`` at the recipe's width: the port's count is
    the JAX model's, and ``chip_smoke.py`` holds it."""
    import chip_smoke
    params = copy.deepcopy(runpy.run_path(os.path.join(
        CONFIGS, "centaur_synthetic.py"))["base_params"])
    params["data_layer_params"].update(num_batches=1, text_length=8,
                                       spec_length=8)
    params["batch_size_per_gpu"] = 1
    count = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(_jax_shapes(params)["params"]))
    model = Text2SpeechCentaur(params, mode="eval", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    with torch.device("meta"):
        module = model.build_module(batch, None)
    assert sum(p.numel() for p in module.parameters()) == count == \
        chip_smoke.CENTAUR_PARAMS


def _main(*argv):
    return run.main(["--config_file=" + TINY, "--device=cpu", *argv])


def test_run_main_trains_evaluates_infers(tmp_path, capsys):
    """The tiny config: 6 steps with checkpoints at 3 and 6, the losses
    finite and falling; eval from the checkpoint ("Validation loss");
    infer, a wav a text."""
    logdir = str(tmp_path / "logs")
    result = _main("--logdir=" + logdir, "--mode=train", "--max_steps=6",
                   "--save_checkpoint_steps=3")
    assert result["steps"] == 6
    losses = [float(x) for x in re.findall(r"loss = ([0-9.]+)",
                                           capsys.readouterr().out)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    metrics = _main("--logdir=" + logdir, "--mode=eval")
    assert "Validation loss" in capsys.readouterr().out
    assert np.isfinite(metrics["eval_loss"])
    out = str(tmp_path / "infer" / "infer.csv")
    _main("--logdir=" + logdir, "--mode=infer", "--infer_output_file=" + out)
    with open(out) as f:
        assert len(f.read().splitlines()) == 8
