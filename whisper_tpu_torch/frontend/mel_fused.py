"""Fused log-mel frontend for the fixed 30 s window (K5).

Counterpart of ``log_mel_spectrogram_fused`` in
``whisper_tpu/frontend/mel_pallas.py:102``. One kernel does the framing
(frame *i* reads samples ``[160 i, 160 i + 400)``, zeros past the end, no
centre padding), the windowed real DFT against a dense cos/sin basis, the
power, the product with the filterbank whose mirrored-bin fold (bins 1..199
doubled) is pre-scaled in, and ``log10(max(·, 1e-10))``. The per-utterance
floor at ``max − 8`` and the affine ``(x + 4) / 4`` run after it as torch
ops, as JAX runs them in XLA after its Pallas call. A CUDA tensor runs the
hand-written kernel ``csrc/log_mel_fused.cu``; a CPU tensor runs
:func:`log_mel_spectrogram_fused_reference`, the plain version. There is no
fallback: a CUDA tensor the kernel does not take raises.

The filters are the librosa-equivalent bank (``frontend/filters.py``) that
JAX bakes into its kernel; for other filters use ``frontend/mel.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.frontend.mel import _dft_window_matrices, _frame

KERNEL = "log_mel_fused"
KERNEL_SYMBOL = "log_mel_fused_kernel"  # in the names of its device functions (profiler traces)
N_BINS = N_FFT // 2 + 1  # 201
BIN_PAD = 224  # the kernel's bins: 7 per thread column of 32
MEL_PAD = 128  # most mels; the filterbank's mel axis is padded to it

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


@functools.lru_cache(maxsize=4)
def _basis(n_mels: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's constants, host float32: the windowed-DFT basis [400,
    2·BIN_PAD] (cos in columns 0..200, sin in BIN_PAD..BIN_PAD+200, zeros
    elsewhere) and the fold-prescaled filterbank transposed to [201,
    MEL_PAD] (mels past ``n_mels`` zero)."""
    w_cos, w_sin = _dft_window_matrices(N_FFT)  # [400, 201] float64
    w = np.zeros((N_FFT, 2 * BIN_PAD), np.float32)
    w[:, :N_BINS] = w_cos
    w[:, BIN_PAD : BIN_PAD + N_BINS] = w_sin
    fold = np.ones((N_BINS,), np.float32)
    fold[1:-1] = 2.0
    filt = np.asarray(mel_filterbank(n_fft=N_FFT, n_mels=n_mels), np.float32)
    filt_t = np.zeros((N_BINS, MEL_PAD), np.float32)
    filt_t[:, :n_mels] = (filt * fold[None, :]).T
    return w, filt_t


@functools.lru_cache(maxsize=8)
def _device_basis(device: torch.device, n_mels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_basis` on ``device``, uploaded once: a copy from host memory
    on every call would wait for the work queued before it."""
    return tuple(torch.from_numpy(a).to(device) for a in _basis(n_mels))


def _check(samples: torch.Tensor, n_mels: int) -> None:
    if samples.shape[-1] != N_SAMPLES:
        raise ValueError(f"fused mel requires {N_SAMPLES} samples, got {samples.shape[-1]}")
    if not 0 < n_mels <= MEL_PAD:
        raise ValueError(f"n_mels {n_mels} not in [1, {MEL_PAD}]")


def _epilogue(log_spec: torch.Tensor, batch_shape) -> torch.Tensor:
    """[b, n_mels, F] log10 mel → the per-utterance clamp and affine
    (whisper.cpp:196-213), in the caller's batch shape."""
    mmax = torch.amax(log_spec, dim=(-1, -2), keepdim=True)
    out = (torch.maximum(log_spec, mmax - 8.0) + 4.0) / 4.0
    return out.reshape(*batch_shape, *log_spec.shape[-2:])


def log_mel_spectrogram_fused_reference(samples: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain version: the kernel's function on the same constants, with
    torch matmuls."""
    _check(samples, n_mels)
    batch_shape = samples.shape[:-1]
    x = samples.reshape(-1, N_SAMPLES).to(torch.float32)
    w, filt = _device_basis(x.device, n_mels)
    frames = _frame(x, N_FFT, HOP_LENGTH, N_FRAMES)  # [b, F, 400]
    re = frames @ w[:, :N_BINS]
    im = frames @ w[:, BIN_PAD : BIN_PAD + N_BINS]
    mel = (re * re + im * im) @ filt[:, :n_mels]  # [b, F, n_mels]
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10)).transpose(-1, -2)
    return _epilogue(log_spec, batch_shape)


def log10_mel_kernel(x: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel alone: CUDA ``[B, 480000]`` float32 → ``[B, n_mels,
    3000]`` ``log10(max(mel, 1e-10))``, before the epilogue."""
    global launches
    if x.device.type != "cuda" or x.dim() != 2:
        raise ValueError(f"{KERNEL}: needs a CUDA [B, {N_SAMPLES}] tensor, got {x.device} {tuple(x.shape)}")
    _check(x, n_mels)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"{KERNEL}: samples must be contiguous float32, got {x.dtype}")
    b = x.shape[0]
    w, filt = _device_basis(x.device, n_mels)
    out = torch.empty((b, n_mels, N_FRAMES), dtype=torch.float32, device=x.device)
    if b:
        rc = _library().log_mel_fused(
            x.data_ptr(), w.data_ptr(), filt.data_ptr(), out.data_ptr(), b, n_mels,
            x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
        launches += 1
    return out


def log_mel_spectrogram_fused(samples: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """``[..., 480000] → [..., n_mels, 3000]`` log-mel features. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the whole batch), then the torch epilogue."""
    if samples.device.type == "cpu":
        return log_mel_spectrogram_fused_reference(samples, n_mels)
    if samples.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {samples.device}")
    _check(samples, n_mels)
    if not samples.is_floating_point():
        raise TypeError(f"{KERNEL}: samples must be float, got {samples.dtype}")
    x = samples.reshape(-1, N_SAMPLES).to(torch.float32).contiguous()
    return _epilogue(log10_mel_kernel(x, n_mels), samples.shape[:-1])


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    fn = lib.log_mel_fused
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
