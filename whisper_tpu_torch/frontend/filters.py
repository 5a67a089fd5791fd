"""Mel filterbank construction (Slaney scale + Slaney area normalization).

The reference never computes filters — it loads a precomputed [n_mel, 201]
matrix from the vocab ``.bin`` (whisper.cpp:519-545), which upstream tooling
generated with librosa defaults. We recompute the same matrix with the
standard public Slaney formulas so no binary asset is required; the .bin
loader (tokenizer/binfmt.py) remains the compat path and tests assert both
agree when a .bin is present.
"""

from __future__ import annotations

import numpy as np

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq * 3.0 / 200.0
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * 200.0 / 3.0
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sample_rate: int = 16_000,
    n_fft: int = 400,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_mels, n_fft // 2 + 1]``.

    Matches librosa.filters.mel(htk=False, norm="slaney") — the provenance of
    the matrix baked into the reference's assets (80×201 floats in the .bin,
    whisper.h:223-227).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
