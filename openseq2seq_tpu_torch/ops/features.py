"""Speech featurization on the host, in numpy and scipy (the port's copy of
``openseq2seq_tpu/ops/features.py``, unchanged in behaviour: the same
signal and parameters give the same features, bit for bit).

Re-implements the behavior of the reference's librosa backend
(`open_seq2seq/data/speech2text/speech_utils.py:270-447`) with no
external audio dependency: signal normalization, optional speed-perturb
and additive-noise augmentation, preemphasis, centered STFT (reflect
padding, symmetric hann/hamming windows — the reference passes
``np.hanning``), and three feature types:

  * ``spectrogram`` — 10*log10 power spectrogram, low ``num_features``
    bins kept;
  * ``logfbank``   — log(mel power + 1e-20) with a Slaney-normalized mel
    filterbank (librosa.filters.mel defaults: htk=False, norm='slaney');
  * ``mfcc``       — DCT-II (ortho) of the dB mel spectrogram.

Followed by mean/std normalization (optionally per-feature, optionally
with precomputed stats) and SpecAugment-style frequency/time masking.
Featurizing on the device (``featurize_on_device``) is
``ops/features_device.py``.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple

import numpy as np
from scipy.fftpack import dct
from scipy.io import wavfile
from scipy.signal import resample_poly

WINDOWS_FNS = {"hanning": np.hanning, "hamming": np.hamming, "none": None}


def normalize_signal(signal: np.ndarray, gain: Optional[float] = None):
    """Normalize float signal to [-1, 1] (or apply an explicit gain)."""
    if gain is None:
        gain = 1.0 / (np.max(np.abs(signal)) + 1e-5)
    return signal * gain


def preemphasis(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    return np.append(signal[0], signal[1:] - coeff * signal[:-1])


def _hz_to_mel(freq):
    """Slaney mel scale (librosa default, htk=False)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + math.log(freq / min_log_hz) / logstep
    return mels


def _mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * math.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(sample_freq: int, num_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+nfft/2)."""
    if fmax is None:
        fmax = sample_freq / 2.0
    fft_freqs = np.linspace(0, sample_freq / 2.0, 1 + num_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_power(signal: np.ndarray, n_fft: int, hop_length: int,
               win_length: int, window_fn=np.hanning) -> np.ndarray:
    """Power of a centered STFT, shape (1+n_fft/2, frames). Matches
    librosa.core.stft(center=True) framing: reflect-pad by n_fft//2,
    frames start every hop, symmetric window zero-padded to n_fft."""
    if window_fn is None:
        window = np.ones(win_length)
    else:
        window = window_fn(win_length)
    if win_length < n_fft:
        pad = n_fft - win_length
        window = np.pad(window, (pad // 2, pad - pad // 2))
    signal = np.pad(signal, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(signal) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = signal[idx] * window[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).T.astype(np.float32)


def augment_audio_signal(signal: np.ndarray, sample_freq: int,
                         augmentation: Dict[str, Any],
                         rng: np.random.RandomState) -> np.ndarray:
    """Speed perturbation + additive gaussian noise (reference
    `speech_utils.py:225-268`)."""
    if "speed_perturbation_ratio" in augmentation:
        ratio = augmentation["speed_perturbation_ratio"]
        if isinstance(ratio, (list, tuple)):
            stretch = float(rng.choice(ratio))
        elif ratio > 0:
            stretch = 1.0 + (2.0 * rng.rand() - 1.0) * ratio
        else:
            stretch = -1.0
        if stretch > 0 and abs(stretch - 1.0) > 1e-9:
            frac = Fraction(stretch).limit_denominator(100)
            signal = resample_poly(signal, frac.numerator, frac.denominator)
    if "noise_level_min" in augmentation and "noise_level_max" in augmentation:
        noise_db = rng.randint(low=augmentation["noise_level_min"],
                               high=augmentation["noise_level_max"])
        signal = signal + rng.randn(signal.shape[0]) * 10.0 ** (noise_db / 20.0)
    return signal


def get_speech_features(signal: np.ndarray, sample_freq: int,
                        params: Dict[str, Any],
                        rng: Optional[np.random.RandomState] = None
                        ) -> Tuple[np.ndarray, float]:
    """Convert a raw signal to (features [T, num_features], duration_sec).

    Recognized params (reference-compatible keys): ``num_audio_features``,
    ``input_type`` in {spectrogram, mfcc, logfbank}, ``window_size``,
    ``window_stride`` (seconds), ``window`` in {hanning, hamming, none},
    ``num_fft``, ``dither``, ``gain``, ``norm_per_feature``, ``mel_basis``,
    ``features_mean``/``features_std_dev``, ``augmentation``.
    """
    rng = rng or np.random
    features_type = params.get("input_type", "spectrogram")
    num_features = params["num_audio_features"]
    window_size = params.get("window_size", 20e-3)
    window_stride = params.get("window_stride", 10e-3)
    augmentation = params.get("augmentation", None)
    window_fn = WINDOWS_FNS[params.get("window", "hanning")]
    dither = params.get("dither", 0.0)
    num_fft = params.get("num_fft", None)
    norm_per_feature = params.get("norm_per_feature", False)
    mel_basis = params.get("mel_basis", None)
    gain = params.get("gain", None)
    mean = params.get("features_mean", None)
    std_dev = params.get("features_std_dev", None)

    signal = normalize_signal(signal.astype(np.float32), gain)
    if augmentation:
        signal = augment_audio_signal(signal, sample_freq, augmentation, rng)
    duration = len(signal) / sample_freq

    n_window_size = int(sample_freq * window_size)
    n_window_stride = int(sample_freq * window_stride)
    num_fft = num_fft or 2 ** math.ceil(math.log2(window_size * sample_freq))

    if dither > 0:
        signal = signal + dither * rng.randn(*signal.shape)

    if features_type == "spectrogram":
        powspec = stft_power(signal, n_fft=n_window_size,
                             hop_length=n_window_stride,
                             win_length=n_window_size, window_fn=window_fn)
        powspec[powspec <= 1e-30] = 1e-30
        features = 10 * np.log10(powspec.T)
        if num_features > n_window_size // 2 + 1:
            raise ValueError("num_features for spectrogram should be <= "
                             "(sample_freq * window_size // 2 + 1)")
        features = features[:, :num_features]
    elif features_type == "logfbank":
        signal = preemphasis(signal, coeff=0.97)
        S = stft_power(signal, n_fft=num_fft, hop_length=n_window_stride,
                       win_length=n_window_size, window_fn=window_fn)
        if mel_basis is None:
            mel_basis = mel_filterbank(sample_freq, num_fft,
                                       n_mels=num_features, fmin=0,
                                       fmax=int(sample_freq / 2))
        features = np.log(np.dot(mel_basis, S) + 1e-20).T
    elif features_type == "mfcc":
        signal = preemphasis(signal, coeff=0.97)
        S = stft_power(signal, n_fft=num_fft, hop_length=n_window_stride,
                       win_length=n_window_size, window_fn=window_fn)
        fb = mel_filterbank(sample_freq, num_fft, n_mels=2 * num_features)
        mel_power = np.dot(fb, S)
        # librosa power_to_db: 10*log10(max(S, 1e-10)), ref=1, top_db=80
        db = 10.0 * np.log10(np.maximum(mel_power, 1e-10))
        db = np.maximum(db, db.max() - 80.0)
        features = dct(db, axis=0, type=2, norm="ortho")[:num_features].T
    else:
        raise ValueError("Unknown features type: {}".format(features_type))

    norm_axis = 0 if norm_per_feature else None
    if mean is None:
        mean = np.mean(features, axis=norm_axis)
    if std_dev is None:
        std_dev = np.std(features, axis=norm_axis)
    features = (features - mean) / std_dev

    if augmentation:
        features = _spec_augment(features, augmentation, rng)
    return features.astype(np.float32), duration


def _spec_augment(features: np.ndarray, augmentation: Dict[str, Any],
                  rng) -> np.ndarray:
    """Frequency/time cutout masks (reference `speech_utils.py:421-436`)."""
    n_freq_mask = augmentation.get("n_freq_mask", 0)
    n_time_mask = augmentation.get("n_time_mask", 0)
    width_freq_mask = augmentation.get("width_freq_mask", 10)
    width_time_mask = augmentation.get("width_time_mask", 50)
    for _ in range(n_freq_mask):
        band = rng.randint(width_freq_mask + 1)
        if features.shape[1] - band > 0:
            base = rng.randint(0, features.shape[1] - band)
            features[:, base:base + band] = 0
    for _ in range(n_time_mask):
        band = rng.randint(width_time_mask + 1)
        if features.shape[0] - band > 0:
            base = rng.randint(features.shape[0] - band)
            features[base:base + band, :] = 0
    return features


def get_speech_features_from_file(filename: str, params: Dict[str, Any],
                                  rng=None) -> Tuple[np.ndarray, float]:
    """Load a wav and featurize it. Validates the sample rate against
    ``params['sample_freq']`` like the reference (`speech_utils.py:188-196`)."""
    sample_freq, signal = wavfile.read(filename)
    want = params.get("sample_freq", sample_freq)
    if sample_freq != want:
        raise ValueError(
            "The sampling frequency set in params {} does not match the "
            "frequency {} read from file {}".format(want, sample_freq,
                                                    filename))
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    return get_speech_features(signal, sample_freq, params, rng=rng)
