"""The port's host featurizer (``openseq2seq_tpu_torch/ops/features.py``)
against the JAX package's (``openseq2seq_tpu/ops/features.py``): the same
seeded signals and parameters give the same features, bit for bit (fp32,
tolerance 0: the same numpy code), for the three feature types, with and
without per-feature normalization, SpecAugment masks, speed perturbation
and additive noise; and the same from a wav file."""
import numpy as np
import pytest
from scipy.io import wavfile

from openseq2seq_tpu.ops import features as jax_features
from openseq2seq_tpu_torch.ops import features
from test_torch_text_data import one_thread  # noqa: F401

SR = 16000


def _signal(seed, seconds=0.7):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = np.sin(2 * np.pi * (180 + 40 * seed) * t)
    return (0.4 * tone + 0.05 * rng.randn(t.size)).astype(np.float32)


def _params(input_type, norm_per_feature, augmentation):
    return {"num_audio_features": {"spectrogram": 96, "mfcc": 13,
                                   "logfbank": 40}[input_type],
            "input_type": input_type, "norm_per_feature": norm_per_feature,
            "dither": 1e-5, "window": "hanning",
            "augmentation": augmentation}


AUGMENTATIONS = {
    "none": None,
    "masks": {"n_freq_mask": 2, "n_time_mask": 2, "width_freq_mask": 6,
              "width_time_mask": 6},
    "speed and noise": {"speed_perturbation_ratio": 0.1,
                        "noise_level_min": -90, "noise_level_max": -60},
    "speed choices and masks": {"speed_perturbation_ratio": [0.9, 1.1],
                                "n_freq_mask": 1, "n_time_mask": 1},
}


@pytest.mark.parametrize("augmentation", sorted(AUGMENTATIONS))
@pytest.mark.parametrize("norm_per_feature", [False, True])
@pytest.mark.parametrize("input_type", ["spectrogram", "mfcc", "logfbank"])
def test_features_equal_the_jax_packages(input_type, norm_per_feature,
                                         augmentation):
    p = _params(input_type, norm_per_feature, AUGMENTATIONS[augmentation])
    seed = 3 + len(augmentation)
    got, dur = features.get_speech_features(
        _signal(seed), SR, dict(p), rng=np.random.RandomState(seed))
    want, want_dur = jax_features.get_speech_features(
        _signal(seed), SR, dict(p), rng=np.random.RandomState(seed))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want) and dur == want_dur
    assert np.isfinite(got).all()


def test_mel_basis_and_wav_file_equal_the_jax_packages(tmp_path):
    """The Slaney filterbank, and a 16-bit wav featurized from the file
    with a precomputed mel basis; a file at another rate refused."""
    basis = features.mel_filterbank(SR, 512, 64, fmin=0, fmax=SR // 2)
    assert np.array_equal(basis, jax_features.mel_filterbank(
        SR, 512, 64, fmin=0, fmax=SR // 2))
    path = str(tmp_path / "utt.wav")
    wavfile.write(path, SR, (_signal(9) * 20000).astype(np.int16))
    p = dict(_params("logfbank", True, AUGMENTATIONS["masks"]),
             num_audio_features=64, mel_basis=basis, sample_freq=SR)
    got = features.get_speech_features_from_file(
        path, dict(p), rng=np.random.RandomState(1))
    want = jax_features.get_speech_features_from_file(
        path, dict(p), rng=np.random.RandomState(1))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError, match="sampling frequency"):
        features.get_speech_features_from_file(path, dict(p,
                                                          sample_freq=8000))
