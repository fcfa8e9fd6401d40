"""TTS audio features on the host (port of
``openseq2seq_tpu/data/text2speech/speech_utils.py``, the same numpy
arithmetic): wav -> log magnitude or log mel spectrograms for Tacotron
training, the mel filterbank's pseudo-inverse, and Griffin-Lim phase
reconstruction for synthesis. The mel filterbank is the port's
``ops/features.mel_filterbank``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...ops.features import mel_filterbank


def _stft_complex(signal: np.ndarray, n_fft: int, hop_length: int,
                  win_length: int) -> np.ndarray:
    """The centred (reflect-padded) STFT with a Hann window of
    ``win_length`` zero-padded to ``n_fft``: (1 + n_fft / 2, T) complex."""
    window = np.hanning(win_length)
    if win_length < n_fft:
        pad = n_fft - win_length
        window = np.pad(window, (pad // 2, pad - pad // 2))
    signal = np.pad(signal, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(signal) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :] +
           hop_length * np.arange(n_frames)[:, None])
    frames = signal[idx] * window[None, :]
    return np.fft.rfft(frames, n=n_fft, axis=1).T


def get_speech_features_tts(signal: np.ndarray,
                            sample_freq: int,
                            n_fft: int = 1024,
                            hop_length: Optional[int] = None,
                            win_length: Optional[int] = None,
                            num_mels: int = 80,
                            output_type: str = "mel",
                            mag_power: int = 1,
                            feature_normalize: bool = False,
                            mean: float = 0.0,
                            std: float = 1.0,
                            data_min: float = 1e-5,
                            trim: bool = False,
                            fmax: Optional[float] = None):
    """The log spectrogram of ``signal``, (T, F) time-major, fp32:
    ``output_type`` "mel" the log mel, "magnitude" the log magnitude,
    "both" the pair (mel, magnitude). The signal is peak-normalized, and
    with ``trim`` cut to its first and last sample above 0.01."""
    signal = signal.astype(np.float32)
    if np.max(np.abs(signal)) > 0:
        signal = signal / np.max(np.abs(signal))
    if trim:
        energy = np.abs(signal) > 0.01
        nz = np.nonzero(energy)[0]
        if len(nz):
            signal = signal[nz[0]:nz[-1] + 1]
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    spec = _stft_complex(signal, n_fft, hop_length, win_length)
    mag = np.abs(spec) ** mag_power                   # (F, T)

    def norm(x):
        x = np.log(np.clip(x, data_min, None))
        if feature_normalize:
            x = (x - mean) / std
        return x.T.astype(np.float32)                 # (T, F)

    if output_type == "magnitude":
        return norm(mag)
    mel_fb = mel_filterbank(sample_freq, n_fft, n_mels=num_mels,
                            fmax=fmax or sample_freq / 2.0)
    mel = mel_fb @ mag
    if output_type == "mel":
        return norm(mel)
    return norm(mel), norm(mag)


def inverse_mel(mel_log: np.ndarray, sample_freq: int, n_fft: int,
                num_mels: int, mag_power: int = 1,
                feature_normalize: bool = False, mean: float = 0.0,
                std: float = 1.0, fmax: Optional[float] = None
                ) -> np.ndarray:
    """log mel (T, M) -> approximate linear magnitude (T, 1 + n_fft / 2)
    through the filterbank's pseudo-inverse."""
    if feature_normalize:
        mel_log = mel_log * std + mean
    mel = np.exp(mel_log).T                           # (M, T)
    fb = mel_filterbank(sample_freq, n_fft, n_mels=num_mels,
                        fmax=fmax or sample_freq / 2.0)
    inv = np.linalg.pinv(fb)
    mag = np.maximum(inv @ mel, 1e-10)
    return (mag ** (1.0 / mag_power)).T.astype(np.float32)


def griffin_lim(mag: np.ndarray, n_fft: int = 1024,
                hop_length: Optional[int] = None,
                n_iters: int = 50) -> np.ndarray:
    """Iterative phase reconstruction of the linear magnitude ``mag`` (T,
    1 + n_fft / 2), from phases drawn with seed 0; returns the
    waveform."""
    hop_length = hop_length or n_fft // 4
    spec = mag.T.astype(np.complex128)                # (F, T)
    angles = np.exp(2j * np.pi * np.random.RandomState(0).rand(*spec.shape))
    window = np.hanning(n_fft)

    def istft(S):
        frames = np.fft.irfft(S.T, n=n_fft, axis=1) * window[None, :]
        T = frames.shape[0]
        out = np.zeros(n_fft + hop_length * (T - 1))
        wsum = np.zeros_like(out)
        for t in range(T):
            out[t * hop_length:t * hop_length + n_fft] += frames[t]
            wsum[t * hop_length:t * hop_length + n_fft] += window ** 2
        out = out / np.maximum(wsum, 1e-8)
        return out[n_fft // 2:-(n_fft // 2)] if out.size > n_fft else out

    def stft(x):
        return _stft_complex(x, n_fft, hop_length, n_fft)

    S = spec * angles
    for _ in range(n_iters):
        x = istft(S)
        S_new = stft(x)
        if S_new.shape[1] < spec.shape[1]:
            S_new = np.pad(S_new,
                           ((0, 0), (0, spec.shape[1] - S_new.shape[1])))
        S = spec * np.exp(1j * np.angle(S_new[:, :spec.shape[1]]))
    return istft(S).astype(np.float32)
