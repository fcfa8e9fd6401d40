"""Speech featurization on the device (port of
``openseq2seq_tpu/ops/features_jax.py``): the host log-mel pipeline of
``ops/features.py`` as batched torch operations, so that the model's
forward can featurize padded raw-audio batches (``featurize_on_device``).

It computes the JAX function, not necessarily in its steps:

  * a per-utterance gain from the peak of the signal within its length;
  * preemphasis 0.97;
  * centred frames over a reflect-padded signal, ``T = 1 + N // hop``
    (``Tensor.unfold`` in place of the JAX gather);
  * ``np.hanning``'s symmetric window (``torch.hann_window`` is periodic
    unless told otherwise), zero-padded to ``n_fft``;
  * the power of ``torch.fft.rfft`` in fp32;
  * the Slaney mel filterbank of ``ops/features.py`` as one fp32 product,
    with TF32 off for it;
  * ``log(mel + 1e-20)``, then the mean and variance normalization over
    each utterance's valid frames, per feature or over all of them, and
    the padded frames zeroed.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from .features import mel_filterbank


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """``np.hanning(win_length)`` zero-padded (centred) to ``n_fft``."""
    w = torch.hann_window(win_length, periodic=False, dtype=torch.float64)
    lo = (n_fft - win_length) // 2
    w = F.pad(w, (lo, n_fft - win_length - lo))
    return w.to(device=device, dtype=torch.float32)


@contextlib.contextmanager
def _fp32_matmul():
    """TF32 off for the products inside (the JAX package's filterbank
    product is fp32)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def logmel_features(signals: torch.Tensor, signal_lengths: torch.Tensor,
                    sample_freq: int = 16000, num_features: int = 64,
                    n_fft: int = 512, hop_length: int = 160,
                    win_length: int = 320, norm_per_feature: bool = True,
                    preemph: float = 0.97
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """signals (B, N) in [-1, 1] and their lengths (B,) -> fp32 features
    (B, 1 + N // hop_length, num_features) and their lengths (B,), on the
    signals' device."""
    dev = signals.device
    B, N = signals.shape
    lengths = signal_lengths.to(device=dev, dtype=torch.int64)
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    sig = signals.float() * mask
    peak = sig.abs().amax(dim=1, keepdim=True)
    sig = sig / (peak + 1e-5)
    sig = torch.cat([sig[:, :1], sig[:, 1:] - preemph * sig[:, :-1]], dim=1)

    pad = n_fft // 2
    padded = F.pad(sig[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(1, n_fft, hop_length)          # (B, T, n_fft)
    T = frames.shape[1]
    frames = frames * _window(win_length, n_fft, dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2               # (B, T, F)
    fb = torch.from_numpy(mel_filterbank(sample_freq, n_fft,
                                         n_mels=num_features)).to(dev)
    with _fp32_matmul():
        mel = power @ fb.t()
    feats = torch.log(mel + 1e-20)

    feat_lengths = 1 + lengths // hop_length
    tmask = (torch.arange(T, device=dev)[None, :] <
             feat_lengths[:, None]).float()[:, :, None]   # (B, T, 1)
    denom = tmask.sum(dim=1).clamp(min=1.0)               # (B, 1)
    if norm_per_feature:
        mean = (feats * tmask).sum(dim=1) / denom          # (B, M)
        var = (((feats - mean[:, None]) ** 2) * tmask).sum(dim=1) / denom
        feats = (feats - mean[:, None]) * torch.rsqrt(var + 1e-12)[:, None]
    else:
        total = denom * num_features                       # (B, 1)
        mean = (feats * tmask).sum(dim=(1, 2))[:, None] / total
        var = (((feats - mean[:, :, None]) ** 2) * tmask).sum(
            dim=(1, 2))[:, None] / total
        feats = (feats - mean[:, :, None]) * \
            torch.rsqrt(var + 1e-12)[:, :, None]
    return feats * tmask, feat_lengths.to(signal_lengths.dtype)
