"""The port's WaveNet against the JAX package's, on the same inputs (from
numpy with fixed seeds) and converted weights (every leaf moved by N(0,
0.05^2)):

  * ``mu_law_encode`` and ``mu_law_decode``;
  * the net's logits, labels and decoded outputs, and the gradients of
    the WaveNet loss, with and without conditioning (whose frames are
    repeated, cut and edge-padded to the audio's length); the loss alone;
  * "mixed": the logits within 2^-5 of max(1, |value|) of the JAX
    module's, run op by op with the sigmoid rounded once (as in
    ``test_torch_convs2s.py``);
  * ``wavenet_generate`` at 64 samples: argmax ids and logits equal to the
    JAX function's; the sampled path against the port's own parallel net
    (its logits on the generated audio) and reproducible from its
    generator's seed (``jax.random.categorical`` draws other samples);
  * the data layer's batches, byte for byte, in training (random chunks
    aligned to the mel hop, from the layer's ``RandomState``) and in eval
    (whole clips, the last batch filled out) on a ``fake_ljspeech`` tree;
  * the full-width parameter count by ``jax.eval_shape``;
  * ``run.main`` on the tiny config in train, eval and infer;
  * (slow) the toy recipe to a loss below 3.0, the JAX test's bar.

Tolerance: fp32 rtol 1e-5 (logits atol 1e-5); a gradient within 1e-5 of
its leaf's largest magnitude plus rtol 1e-5; the generation's logits
atol 2e-4, rtol 1e-3, the JAX test's (the fast path sums in another
order than the parallel convs).
"""
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu import encoders as jax_encoders
from openseq2seq_tpu import losses as jax_losses
from openseq2seq_tpu.data.text2speech import \
    WavenetDataLayer as JaxWavenetDataLayer
from openseq2seq_tpu.encoders import wavenet_encoder as jax_wavenet
from openseq2seq_tpu_torch import encoders, losses, run
from openseq2seq_tpu_torch.data.text2speech import WavenetDataLayer
from openseq2seq_tpu_torch.encoders import wavenet_encoder
from openseq2seq_tpu_torch.test_utils import fake_ljspeech
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_convs2s import (_grads, _perturbed_weights, assert_bf16_close,
                                assert_grads_close,
                                jax_sigmoid_rounded_once)  # noqa: F401
# torch on one thread
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2speech")
TINY = os.path.join(CONFIGS, "wavenet_tiny.py")
TOY = os.path.join(CONFIGS, "wavenet_toy.py")
B, T, Q, F, MEL = 2, 40, 16, 8, 6
AUDIO_LEN = np.array([40, 27], np.int32)
ENC = {"layer_type": "conv1d", "kernel_size": 3, "strides": 1,
       "padding": "SAME", "blocks": 2, "layers_per_block": 3,
       "filters": F, "quantization_channels": Q}


def _audio(seed, n=T, batch=B):
    return np.clip(np.random.RandomState(seed).randn(batch, n) * 0.4, -1.0,
                   1.0).astype(np.float32)


def test_mu_law_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 501), _audio(0).ravel()]) \
        .astype(np.float32)
    for q in (64, 256):
        want = np.asarray(jax_wavenet.mu_law_encode(jnp.asarray(x), q))
        got = wavenet_encoder.mu_law_encode(torch.from_numpy(x), q)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(
            wavenet_encoder.mu_law_decode(got, q).numpy(),
            np.asarray(jax_wavenet.mu_law_decode(jnp.asarray(want), q)),
            rtol=1e-6, atol=1e-7)


def _nets(cond, dtype=None, seed=1):
    params = dict(ENC, **({"dtype": dtype} if dtype else {}))
    jenc = jax_encoders.WavenetEncoder(params, None).make_module()
    enc = encoders.WavenetEncoder(params, None).make_module(
        MEL if cond else None, torch.Generator().manual_seed(0))
    return jenc, _perturbed_weights(enc, seed), enc


def _inputs(cond, n_mel=5):
    audio = _audio(2)
    src = [audio, AUDIO_LEN]
    if cond:
        # 5 frames for 40 samples: 8 a frame, none padded; 6 frames: 6 a
        # frame, the last 4 samples the last frame's
        src.append(np.random.RandomState(3).randn(B, n_mel, MEL)
                   .astype(np.float32))
    return ({"source_tensors": [jnp.asarray(x) for x in src]},
            {"source_tensors": [torch.from_numpy(x) for x in src]})


@pytest.mark.parametrize("cond,n_mel", [(False, 0), (True, 5), (True, 6)],
                         ids=["free", "cond", "cond-padded"])
def test_net_and_loss_match_jax(cond, n_mel):
    jenc, variables, enc = _nets(cond)
    jin, tin = _inputs(cond, n_mel)
    jloss = jax_losses.WavenetLoss({}, None)

    @jax.jit
    def jax_run(v):
        def objective(p):
            out = jenc.apply({"params": p}, jin, train=True)
            return jloss.compute_loss({"decoder_output": out}), out
        (loss, out), g = jax.value_and_grad(objective, has_aux=True)(
            v["params"])
        return loss, out, g

    want_loss, want, want_grads = jax.device_get(jax_run(variables))
    got = enc(tin, True)
    loss = losses.WavenetLoss({}, None).compute_loss({"decoder_output": got})
    assert got["logits"].shape == (B, T, Q) and \
        got["logits"].dtype == torch.float32
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               want["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["outputs"][1].numpy(),
                               want["outputs"][1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    loss.backward()
    assert_grads_close(_grads(enc), want_grads)


def test_causal():
    """Changing future samples changes no earlier logit."""
    _, _, enc = _nets(True)
    _, tin = _inputs(True)
    with torch.no_grad():
        a = enc(tin, False)["logits"]
        tin["source_tensors"][0] = tin["source_tensors"][0].clone()
        tin["source_tensors"][0][:, 30:] += 0.3
        b = enc(tin, False)["logits"]
    torch.testing.assert_close(a[:, :31], b[:, :31], rtol=0, atol=0)
    assert not torch.equal(a[:, 31:], b[:, 31:])


def test_mixed_matches_jax(jax_sigmoid_rounded_once):
    """bf16 compute (the one-hot input bf16, ``post2`` fp32): the logits
    within 2^-5 of max(1, |value|) of the JAX module's, op by op."""
    jenc, variables, enc = _nets(True, dtype="mixed", seed=4)
    assert enc.net.dtype == torch.bfloat16
    jin, tin = _inputs(True)
    want = jenc.apply(variables, jin, train=False)
    with torch.no_grad():
        got = enc(tin, False)
    assert got["logits"].dtype == torch.float32
    assert_bf16_close(got["logits"], want["logits"])


def test_generate_argmax_matches_jax():
    """64 samples at temperature 0 from a conditioned net, B 2: the JAX
    function's ids, and its logits."""
    jenc, variables, enc = _nets(True, seed=5)
    mel = np.random.RandomState(6).randn(B, 8, MEL).astype(np.float32)
    want_ids, want_audio, want_logits = jax.device_get(jax.jit(
        lambda p, c: jax_wavenet.wavenet_generate(
            p, 64, blocks=2, layers_per_block=3, kernel_size=3,
            quantization_channels=Q, conditioning=c, batch_size=B))(
                variables["params"]["net"], mel))
    ids, audio, logits = wavenet_encoder.wavenet_generate(
        enc.net, 64, conditioning=torch.from_numpy(mel))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(audio.numpy(), want_audio, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-3,
                               atol=2e-4)


def test_generate_sampled_matches_parallel_net():
    """At temperature 1 the generated audio through the parallel net
    gives the generation's logits, whose mu-law labels are its ids; the
    same seed draws the same samples."""
    _, _, enc = _nets(True, seed=7)
    mel = torch.from_numpy(np.random.RandomState(8).randn(B, 8, MEL)
                           .astype(np.float32))
    ids, audio, logits = wavenet_encoder.wavenet_generate(
        enc.net, 64, conditioning=mel, temperature=1.0,
        generator=torch.Generator().manual_seed(9))
    again, _, _ = wavenet_encoder.wavenet_generate(
        enc.net, 64, conditioning=mel, temperature=1.0,
        generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(ids, again, rtol=0, atol=0)
    assert len(torch.unique(ids)) > 4
    with torch.no_grad():
        out = enc.net(audio, torch.full((B,), 64), mel, False)
    torch.testing.assert_close(out["labels"], ids, rtol=0, atol=0)
    np.testing.assert_allclose(logits.numpy(), out["logits"].numpy(),
                               rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def lj_tree(tmp_path_factory):
    return fake_ljspeech.generate(str(tmp_path_factory.mktemp("lj")),
                                  n_clips=5, sample_freq=8000,
                                  min_seconds=0.3, max_seconds=0.9)


def _layer_params(tree, mode):
    return {"dataset_location": tree, "dataset": "LJ",
            "num_audio_features": 10, "output_type": "mel",
            "vocab_file": os.path.join(tree, "vocab_tts.txt"),
            "dataset_files": [os.path.join(tree, "metadata.csv")],
            "feature_normalize": False, "n_fft": 256, "sample_freq": 8000,
            "num_samples": 2048, "batch_size": 2, "mode": mode,
            "shuffle": mode == "train"}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_data_layer_batches_match_jax(lj_tree, mode):
    """Two epochs on each side from the same seed: every batch byte for
    byte (train: shuffled clips cut to 2,048-sample chunks at 64-sample
    hops; eval: whole clips, 3 batches, the last one filled out)."""
    mine = WavenetDataLayer(_layer_params(lj_tree, mode), None)
    theirs = JaxWavenetDataLayer(_layer_params(lj_tree, mode), None)
    mine.seed(11)
    theirs.seed(11)
    for _ in range(2):
        got = list(mine.iterate_one_epoch())
        want = list(theirs.iterate_one_epoch())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in ("source_tensors", "target_tensors"):
                for a, b in zip(g[key], w[key]):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert g["source_ids"].tobytes() == w["source_ids"].tobytes()
            assert int(g["batch_valid"]) == int(w["batch_valid"])
    if mode == "train":
        assert got[0]["source_tensors"][0].shape[1] == 2048
    else:
        assert int(got[-1]["batch_valid"]) == 1


def test_full_width_parameter_count():
    """``wavenet_LJ.py`` at the recipe's width (80 mel bins of
    conditioning): the port's parameter count is the JAX model's, and
    ``chip_smoke.py`` holds it."""
    import chip_smoke
    ep = runpy.run_path(os.path.join(CONFIGS, "wavenet_LJ.py"))[
        "base_params"]["encoder_params"]
    jenc = jax_encoders.WavenetEncoder(ep, None).make_module()
    shapes = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), {"source_tensors": [
            jnp.zeros((1, 256)), jnp.full((1,), 256, jnp.int32),
            jnp.zeros((1, 1, 80))]}, train=False))
    count = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        enc = encoders.WavenetEncoder(ep, None).make_module(80, None)
    assert sum(p.numel() for p in enc.parameters()) == count == \
        chip_smoke.WAVENET_PARAMS


def _main(config, *argv):
    return run.main(["--config_file=" + config, "--device=cpu", *argv])


def test_run_main_trains_evaluates_infers(tmp_path, monkeypatch, capsys):
    """The tiny config ("mixed"): 4 steps with checkpoints at 2 and 4,
    the losses finite; eval ("Validation loss") and infer (a wav a tone)
    from the checkpoint."""
    from scipy.io import wavfile
    monkeypatch.setenv("OS2S_TOY_WAVENET_DIR", str(tmp_path / "data"))
    logdir = str(tmp_path / "logs")
    result = _main(TINY, "--logdir=" + logdir, "--mode=train")
    assert result["steps"] == 4
    losses = [float(x) for x in re.findall(r"loss = ([0-9.]+)",
                                           capsys.readouterr().out)]
    assert len(losses) == 4 and all(np.isfinite(losses))
    metrics = _main(TINY, "--logdir=" + logdir, "--mode=eval")
    assert "Validation loss" in capsys.readouterr().out
    assert np.isfinite(metrics["eval_loss"])
    out = str(tmp_path / "infer" / "infer.csv")
    _main(TINY, "--logdir=" + logdir, "--mode=infer",
          "--infer_output_file=" + out)
    with open(out) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3]
    assert all(len(wavfile.read(r[1])[1]) == 8192 for r in rows)


@pytest.mark.slow
def test_wavenet_toy_loss_below_bar(tmp_path, monkeypatch, capsys):
    """``wavenet_toy.py`` through ``run.main --mode=train`` to its end:
    the last loss below 3.0 (``tests/test_wavenet.py``'s bar)."""
    monkeypatch.setenv("OS2S_TOY_WAVENET_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OS2S_TOY_LOGDIR", str(tmp_path / "logs"))
    result = _main(TOY, "--mode=train")
    assert result["steps"] == 200
    assert float(result["last_metrics"]["loss"]) < 3.0
