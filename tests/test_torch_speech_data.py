"""The port's wav data layer (``openseq2seq_tpu_torch/data/speech2text``)
against the JAX package's (``openseq2seq_tpu/data/speech2text``): with
the same params and seed, over two epochs, the same batches: features
(fp32, tolerance 0; bf16 equal once both are read as fp32), lengths,
labels, ``source_ids`` and ``batch_valid``, in train (shuffled, dither
and SpecAugment masks drawn per example), eval and infer; on the
10-utterance toy set and on a 16-utterance LibriSpeech-shaped corpus
read as the Jasper recipe reads it (bf16 features, the feature cache
cold in the first epoch and warm in the second). The port's thread pool
and process pool give the same batches; a wav that cannot be read is
skipped in training and raises in eval; what is not ported, and what
the JAX layer declares but never reads, is refused."""
import os

import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.speech2text import \
    Speech2TextDataLayer as JaxSpeech2TextDataLayer
from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.test_utils import fake_librispeech, toy_speech
from test_torch_text_data import one_thread  # noqa: F401

MASKS = {"n_freq_mask": 2, "n_time_mask": 2, "width_freq_mask": 6,
         "width_time_mask": 6}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    csv_path, vocab = toy_speech.generate(str(d))
    return {"num_audio_features": 40, "input_type": "logfbank",
            "vocab_file": vocab, "dataset_files": [csv_path], "pad_to": 16,
            "norm_per_feature": True, "window": "hanning",
            "precompute_mel_basis": True, "sample_freq": 16000,
            "batch_size": 4}


@pytest.fixture(scope="module")
def libri(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("librispeech"))
    fake_librispeech.generate(d, n_utts=16, seed=3)
    # the dev list: the generator's first 64 rows, here its first 6
    dev = os.path.join(d, "librivox-dev-clean.csv")
    with open(dev) as f:
        rows = f.read().splitlines()
    with open(dev, "w") as f:
        f.write("\n".join(rows[:7]) + "\n")
    return {"num_audio_features": 64, "input_type": "logfbank",
            "vocab_file": os.path.join(d, "vocab.txt"),
            "dataset_files": [os.path.join(d, n) for n in (
                "librivox-train-clean-100.csv",
                "librivox-train-clean-360.csv",
                "librivox-train-other-500.csv")],
            "norm_per_feature": True, "window": "hanning",
            "precompute_mel_basis": True, "sample_freq": 16000,
            "pad_to": 16, "dither": 1e-5, "backend": "librosa",
            "cache_features": True, "features_dtype": "bfloat16",
            "augmentation": dict(MASKS), "batch_size": 6,
            "max_duration": 16.7}


def _batches(cls, params, epochs=2, seed=7):
    dl = cls(dict(params), None)
    dl.seed(seed)
    return [b for _ in range(epochs) for b in dl.iterate_one_epoch()]


def _host(x):
    """A batch's features as fp32 numpy (a bf16 tensor or array read as
    fp32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(_host(g["source_tensors"][0]),
                              _host(w["source_tensors"][0]))
        assert np.array_equal(g["source_tensors"][1], w["source_tensors"][1])
        assert np.array_equal(g["source_ids"], w["source_ids"])
        assert int(g["batch_valid"]) == int(w["batch_valid"])
        assert ("target_tensors" in g) == ("target_tensors" in w)
        for a, b in zip(g.get("target_tensors", ()),
                        w.get("target_tensors", ())):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "eval", "infer"])
def test_toy_batches_equal_the_jax_layers(toy, mode):
    """Two epochs of the toy set in batches of 4 (the last padded, 2
    valid): shuffled with dither and masks in train, in order in eval
    (features cached by default) and infer."""
    params = dict(toy, mode=mode)
    if mode == "train":
        params.update(dither=1e-5, augmentation=dict(MASKS))
    got = _batches(Speech2TextDataLayer, params)
    _assert_same(got, _batches(JaxSpeech2TextDataLayer, params))
    assert len(got) == 6 and int(got[2]["batch_valid"]) == 2
    assert got[0]["source_tensors"][0].dtype == np.float32
    if mode == "train":
        assert not np.array_equal(got[0]["source_ids"], np.arange(4))
        assert not np.array_equal(_host(got[0]["source_tensors"][0]),
                                  _host(got[3]["source_tensors"][0]))
    else:
        assert np.array_equal(got[0]["source_ids"], np.arange(4))


@pytest.mark.parametrize("mode", ["train", "eval", "infer"])
def test_librispeech_shaped_bf16_cold_and_warm_cache(libri, tmp_path, mode):
    """The Jasper recipe's data params on 16 ten-second utterances (three
    train CSVs, two of them empty; the dev CSV, its first 6, for eval and
    infer, without the masks, as the recipe's eval and infer params;
    140-char transcripts; bf16 features): two epochs equal to the JAX
    layer's, each layer with its own feature cache, cold in the first
    epoch and warm in the second; a second port layer reading the warm
    cache from the start gives the same batches. The features are a bf16
    tensor of shape (6, 1008, 64)."""
    params = dict(libri, mode=mode)
    if mode != "train":
        dev = os.path.join(os.path.dirname(libri["vocab_file"]),
                           "librivox-dev-clean.csv")
        params.update(dataset_files=[dev], augmentation={}, shuffle=False)
        params.pop("max_duration")
    port = dict(params, cache_format=str(tmp_path / "port"))
    got = _batches(Speech2TextDataLayer, port)
    assert len(os.listdir(tmp_path / "port")) == (16 if mode == "train"
                                                  else 6)
    want = _batches(JaxSpeech2TextDataLayer,
                    dict(params, cache_format=str(tmp_path / "jax")))
    _assert_same(got, want)
    x = got[0]["source_tensors"][0]
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (6, 1008, 64)
    if mode != "infer":
        assert got[0]["target_tensors"][1].tolist() == [140] * 6
    _assert_same(_batches(Speech2TextDataLayer, port), got)


def test_process_pool_equals_thread_pool(toy):
    """One epoch of the augmented toy set featurized by two worker
    processes, equal to the thread pool's."""
    params = dict(toy, mode="train", dither=1e-5, augmentation=dict(MASKS),
                  map_parallel_calls=2)
    _assert_same(_batches(Speech2TextDataLayer,
                          dict(params, use_process_pool=True), epochs=1),
                 _batches(Speech2TextDataLayer, params, epochs=1))


def test_unreadable_wav_skipped_in_train_raised_in_eval(toy, tmp_path):
    with open(toy["dataset_files"][0]) as f:
        rows = f.read().splitlines()
    bad = tmp_path / "bad.csv"
    bad.write_text("\n".join(rows[:3] + ["/nonexistent/x.wav,0,abc"]) + "\n")
    params = dict(toy, dataset_files=[str(bad)], batch_size=2)
    got = _batches(Speech2TextDataLayer, dict(params, mode="train"), 1)
    assert sorted(i for b in got for i in
                  b["source_ids"][:int(b["batch_valid"])]) == [0, 1]
    with pytest.raises(OSError):
        _batches(Speech2TextDataLayer, dict(params, mode="eval"), 1)


def test_unported_options_raise(toy):
    # featurize_on_device takes what the JAX layer takes
    for extra, match in (({"input_type": "mfcc"}, "logfbank"),
                         ({"augmentation": MASKS}, "augmentation")):
        with pytest.raises(ValueError, match=match):
            Speech2TextDataLayer(dict(toy, mode="train",
                                      featurize_on_device=True, **extra),
                                 None)
    # declared by the JAX layer and read nowhere: refused, not ignored
    for key, value in (("max_batch_pad_time", 100),
                       ("sort_by_duration", True)):
        with pytest.raises(ValueError, match=key):
            Speech2TextDataLayer(dict(toy, mode="train", **{key: value}),
                                 None)
    dl = Speech2TextDataLayer(dict(toy, mode="infer"), None)
    with pytest.raises(FileNotFoundError):
        dl.create_interactive_batch("x.wav")
    with pytest.raises(ImportError, match="sentencepiece"):
        Speech2TextDataLayer(dict(toy, mode="train", bpe=True), None)
    assert dl.params["tgt_vocab_size"] == 10
    assert dl.decode_ids([1, 2, 0, -1]) == "ab "
