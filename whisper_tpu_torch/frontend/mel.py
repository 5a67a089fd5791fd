"""Log-mel spectrogram frontend.

Counterpart of ``whisper_tpu/frontend/mel.py``, with its numeric contract
(reference log_mel_spectrogram, whisper.cpp:109-216):

* 16 kHz, n_fft 400, hop 160, 30 s chunk → 3000 frames;
* periodic Hann window ``0.5*(1-cos(2πi/400))`` folded into a windowed
  real-DFT basis built in float64 and then cast;
* NO center padding: frame *i* reads ``x[160 i : 160 i + 400]`` with zeros
  past the end only (``torch.stft(center=True)`` would reflect-pad both
  ends and give other frames);
* power spectrum with bins 1..199 doubled (the mirrored-bin fold);
* mel = filterbank · power; ``log10(max(·,1e-10))``; per-utterance floor at
  ``max-8`` over the whole [F, n_mels] plane; affine ``(x+4)/4``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.config import HOP_LENGTH, N_FFT, N_SAMPLES
from whisper_tpu_torch.frontend.filters import mel_filterbank


def pad_or_trim(samples: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Pad with zeros / truncate the last axis to ``length``."""
    n = samples.shape[-1]
    if n == length:
        return samples
    if n > length:
        return samples[..., :length]
    return torch.nn.functional.pad(samples, (0, length - n))


@functools.lru_cache(maxsize=8)
def _dft_window_matrices(n_fft: int):
    """Windowed real-DFT basis: W_cos, W_sin of shape [n_fft, n_bins],
    float64 numpy."""
    n_bins = n_fft // 2 + 1
    i = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))  # whisper.cpp:117-120
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(i, k) / n_fft  # [n_fft, n_bins]
    w_cos = np.cos(ang) * window[:, None]
    w_sin = -np.sin(ang) * window[:, None]
    return w_cos, w_sin


@functools.lru_cache(maxsize=8)
def _device_dft(n_fft: int, device: torch.device, dtype: torch.dtype):
    """:func:`_dft_window_matrices` and the fold of mirrored bins
    (whisper.cpp:159-166: bins 1..n_fft/2-1 doubled, DC and Nyquist left
    alone) on ``device`` in ``dtype``, uploaded once: a copy from host
    memory waits for the card."""
    fold = np.full(n_fft // 2 + 1, 2.0)
    fold[0] = fold[-1] = 1.0
    return tuple(
        torch.from_numpy(w).to(device=device, dtype=dtype)
        for w in (*_dft_window_matrices(n_fft), fold)
    )


def _frame(signal: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """[..., n_samples] → [..., n_frames, n_fft]; frame[i, j] = x[hop*i + j],
    zero past the end of the signal."""
    padded = pad_or_trim(signal, (n_frames - 1) * hop + n_fft)
    return padded.unfold(-1, n_fft, hop)


def log_mel_spectrogram(
    samples: torch.Tensor,
    filters: Optional[torch.Tensor] = None,
    n_mels: int = 80,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``[..., n_samples] → [..., n_mels, n_frames]`` log-mel features,
    ``n_frames = n_samples // hop``."""
    device = samples.device
    if filters is None:
        filters = torch.from_numpy(mel_filterbank(n_fft=n_fft, n_mels=n_mels))
    filters = torch.as_tensor(filters).to(device=device, dtype=compute_dtype)
    n_frames = samples.shape[-1] // hop
    x = samples.to(compute_dtype)

    frames = _frame(x, n_fft, hop, n_frames)  # [..., F, n_fft]
    w_cos, w_sin, fold = _device_dft(n_fft, device, compute_dtype)

    re = frames @ w_cos  # [..., F, n_bins]
    im = frames @ w_sin
    power = re * re + im * im
    power = power * fold

    mel = power @ filters.t()  # [..., F, n_mels]
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))

    # Per-utterance dynamic-range clamp (whisper.cpp:196-213): max over the
    # full [F, n_mels] plane of each leading-batch element.
    mmax = torch.amax(log_spec, dim=(-1, -2), keepdim=True)
    log_spec = torch.maximum(log_spec, mmax - 8.0)
    log_spec = (log_spec + 4.0) / 4.0

    return log_spec.transpose(-1, -2)  # [..., n_mels, F]
