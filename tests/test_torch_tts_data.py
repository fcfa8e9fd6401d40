"""The port's text-to-speech data against the JAX package's, on the tone
corpus of ``test_utils/toy_tts.py``:

  * the two generators write identical files;
  * ``speech_utils``: the log mel and log magnitude features (with and
    without trim, normalization, ``mag_power`` 2), the filterbank's
    pseudo-inverse and Griffin-Lim, within 1e-6;
  * ``Text2SpeechDataLayer`` batches in train (shuffled from the same
    seed), eval and infer, for each ``output_type``, without the EOS
    frame, with ``duration_min``/``duration_max``, ``n_samples_eval`` and
    the eval split among workers: equal arrays, exactly;
  * ``SyntheticTTSDataLayer`` batches in each mode, exactly;
  * the interactive infer batch of one sentence, equal to the JAX
    layer's.
"""
import filecmp
import os

import numpy as np
import pytest

from openseq2seq_tpu.data.synthetic import \
    SyntheticTTSDataLayer as JaxSyntheticTTS
from openseq2seq_tpu.data.text2speech import \
    Text2SpeechDataLayer as JaxText2Speech
from openseq2seq_tpu.data.text2speech import speech_utils as jax_utils
from openseq2seq_tpu.test_utils import toy_tts as jax_toy_tts
from openseq2seq_tpu_torch.data import SyntheticTTSDataLayer
from openseq2seq_tpu_torch.data.text2speech import Text2SpeechDataLayer
from openseq2seq_tpu_torch.data.text2speech import speech_utils
from openseq2seq_tpu_torch.test_utils import toy_tts
from test_torch_text_data import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts")
    toy_tts.generate(str(root / "port"))
    jax_toy_tts.generate(str(root / "jax"))
    return str(root / "port"), str(root / "jax")


def test_generators_write_identical_files(corpora):
    mine, theirs = corpora
    names = ["metadata.csv", "vocab.txt"] + [
        os.path.join("wavs", n) for n in sorted(os.listdir(
            os.path.join(theirs, "wavs")))]
    assert len(names) == 12
    for name in names:
        assert filecmp.cmp(os.path.join(mine, name),
                           os.path.join(theirs, name), shallow=False), name


def _signal(seed=0, n=7000):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    sig = 0.6 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.randn(n)
    sig[:300] = 0.001 * rng.randn(300)         # what trim cuts
    return sig.astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    dict(output_type="mel", num_mels=20, n_fft=512),
    dict(output_type="magnitude", n_fft=256, mag_power=2, trim=True),
    dict(output_type="both", num_mels=16, n_fft=512, feature_normalize=True,
         mean=-3.0, std=2.5, fmax=8000.0),
], ids=["mel", "magnitude", "both"])
def test_features_match_jax(kwargs):
    sig = _signal()
    got = speech_utils.get_speech_features_tts(sig, 22050, **kwargs)
    want = jax_utils.get_speech_features_tts(sig, 22050, **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_inverse_mel_and_griffin_lim_match_jax():
    mel = speech_utils.get_speech_features_tts(_signal(1), 22050, n_fft=512,
                                               num_mels=20)
    kw = dict(sample_freq=22050, n_fft=512, num_mels=20, mag_power=1,
              feature_normalize=True, mean=0.5, std=1.5)
    mag = speech_utils.inverse_mel(mel, **kw)
    np.testing.assert_allclose(mag, jax_utils.inverse_mel(mel, **kw),
                               rtol=1e-6, atol=1e-6)
    wav = speech_utils.griffin_lim(mag, n_fft=512, n_iters=3)
    want = jax_utils.griffin_lim(mag, n_fft=512, n_iters=3)
    assert wav.shape == want.shape and wav.dtype == np.float32
    np.testing.assert_allclose(wav, want, rtol=1e-6, atol=1e-6)


def _params(data_dir, mode, **extra):
    params = {"mode": mode, "batch_size": 4, "dataset_location": data_dir,
              "dataset": "LJ", "num_audio_features": 20,
              "output_type": "mel",
              "vocab_file": os.path.join(data_dir, "vocab.txt"),
              "dataset_files": [os.path.join(data_dir, "metadata.csv")],
              "feature_normalize": False, "n_fft": 512,
              "sample_freq": 22050}
    params.update(extra)
    if mode != "train":
        params["shuffle"] = False
    return params


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            gv, wv = g[key], w[key]
            if isinstance(wv, list):
                assert len(gv) == len(wv)
                for a, b in zip(gv, wv):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                assert np.asarray(gv).dtype == np.asarray(wv).dtype
                np.testing.assert_array_equal(gv, wv, err_msg=key)


def _layers(data_dir, mode, num_workers=1, worker_id=0, **extra):
    mine = Text2SpeechDataLayer(_params(data_dir, mode, **extra), None,
                                num_workers, worker_id)
    theirs = JaxText2Speech(_params(data_dir, mode, **extra), None,
                            num_workers, worker_id)
    mine.seed(3)
    theirs.seed(3)
    return mine, theirs


@pytest.mark.parametrize("mode,extra", [
    ("train", {}),
    ("train", {"output_type": "both",
               "num_audio_features": {"mel": 20, "magnitude": 40},
               "pad_EOS": False, "pad_to": 4}),
    ("eval", {"output_type": "magnitude", "num_audio_features": 60,
              "trim": True, "feature_normalize": True,
              "feature_normalize_mean": -4.0,
              "feature_normalize_std": 2.0}),
    ("eval", {"duration_min": 60, "duration_max": 100,
              "n_samples_eval": 9}),
    ("infer", {}),
], ids=["train", "both", "magnitude", "durations", "infer"])
def test_data_layer_batches_match_jax(corpora, mode, extra):
    mine, theirs = _layers(corpora[0], mode, **extra)
    assert mine.params["src_vocab_size"] == theirs.params[
        "src_vocab_size"] == 4
    assert mine.params["num_output_features"] == theirs.params[
        "num_output_features"]
    assert mine.get_size_in_samples() == theirs.get_size_in_samples()
    for _ in range(2):          # two epochs: the shuffle's stream too
        got = list(mine.iterate_one_epoch())
        want = list(theirs.iterate_one_epoch())
        _assert_batches_equal(got, want)
    if mode == "infer":
        assert "target_tensors" not in got[0]
        return
    spec, stop, spec_len = got[0]["target_tensors"]
    eos = 0 if extra.get("pad_EOS") is False else 1
    for i in range(spec.shape[0]):
        n = int(spec_len[i])
        # 0 keeps going over the frames, 1 stops on the padding
        assert not stop[i, :n - eos].any() and stop[i, n - eos:].all()


def test_eval_split_among_workers_matches_jax(corpora):
    for worker in range(3):
        mine, theirs = _layers(corpora[0], "eval", num_workers=3,
                               worker_id=worker)
        assert mine.get_size_in_samples() == [3, 3, 4][worker]
        _assert_batches_equal(list(mine.iterate_one_epoch()),
                              list(theirs.iterate_one_epoch()))


def test_text_encoding_and_interactive_infer(corpora):
    mine, theirs = _layers(corpora[0], "infer")
    np.testing.assert_array_equal(mine.encode_text("ab ba?"),
                                  theirs.encode_text("ab ba?"))
    assert mine.encode_text("ab")[-1] == mine.eos_char_id == 3
    assert mine.decode_ids([0, 1, 2, 3]) == "ab "
    mine, theirs = _layers(corpora[0], "infer", interactive=True)
    _assert_batches_equal([mine.create_interactive_batch(" Ab ba ")],
                          [theirs.create_interactive_batch(" Ab ba ")])
    with pytest.raises(ValueError, match="empty"):
        mine.create_interactive_batch("  ")


@pytest.mark.parametrize("mode", ["train", "eval", "infer"])
def test_synthetic_tts_batches_match_jax(mode):
    params = {"mode": mode, "batch_size": 3, "src_vocab_size": 12,
              "num_audio_features": 5, "text_length": 7,
              "spec_length": 9, "num_batches": 2}
    mine = SyntheticTTSDataLayer(dict(params), None)
    theirs = JaxSyntheticTTS(dict(params), None)
    assert mine.params["num_output_features"] == 5
    assert mine.get_size_in_samples() == theirs.get_size_in_samples() == 6
    _assert_batches_equal(list(mine.iterate_one_epoch()),
                          list(theirs.iterate_one_epoch()))
