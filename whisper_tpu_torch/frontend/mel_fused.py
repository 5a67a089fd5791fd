"""Fused log-mel frontend for the fixed 30 s window (K5).

Counterpart of ``log_mel_spectrogram_fused`` in
``whisper_tpu/frontend/mel_pallas.py:102``. One kernel does the framing
(frame *i* reads samples ``[160 i, 160 i + 400)``, zeros past the end, no
centre padding), the windowed real DFT, the power, the product with the
filterbank whose mirrored-bin fold (bins 1..199 doubled) is pre-scaled in,
and ``log10(max(·, 1e-10))``. The kernel factorises the DFT as 400 = 20 ×
20 and takes the filterbank as per-mel bin ranges (:func:`_plan`); the
plain version multiplies by the dense basis of :func:`_basis`. The per-utterance
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
BIN_PAD = 224  # the plain version's basis: its cos and sin halves, each padded to it
MEL_PAD = 128  # most mels; the filterbank's mel axis is padded to it
RADIX = 20  # N_FFT = RADIX * RADIX: the kernel's two DFT stages
MAX_NNZ = 416  # the kernel's room for the filterbank's non-zeros
# Float offsets of the kernel's table (csrc/log_mel_fused.cu kWinOff ...).
TW_COS, TW_SIN, MEL_W = N_FFT, 2 * N_FFT, 3 * N_FFT

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


@functools.lru_cache(maxsize=4)
def _basis(n_mels: int) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version's constants (JAX's ``_basis`` values), host
    float32: the windowed-DFT basis [400, 2·BIN_PAD] (cos in columns
    0..200, sin in BIN_PAD..BIN_PAD+200, zeros elsewhere) and the
    fold-prescaled filterbank transposed to [201, MEL_PAD] (mels past
    ``n_mels`` zero), from which :func:`_plan` takes the kernel's sparse
    one."""
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


@functools.lru_cache(maxsize=4)
def _plan(n_mels: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's constants, built in float64 and rounded to float32 (the
    index map is in ``csrc/log_mel_fused.cu``'s note):

    * ``table`` f32 [3·400 + MAX_NNZ]: the Hann window [400]; the twiddles
      ``cos`` and ``sin`` of ``2π·n2·k1/400`` as [k1][n2] (20 × 20 each,
      W = cos − i·sin); then each mel's filterbank weights over its bins
      ``[lo, hi)``, mel after mel (fold pre-scaled, zeros after);
    * ``ranges`` int32 [2·n_mels + 1]: ``lo`` of each mel, then the offsets
      of each mel's weights in the table's weight section (n_mels + 1);
    * ``dft20`` f32 [40]: ``cos`` then ``sin`` of ``2π·j/20``, j < 20, the
      table of both DFT stages (kernel parameters).

    The ranges come from :func:`_basis`'s dense filterbank, whose non-zeros
    are contiguous in each mel."""
    n = np.arange(N_FFT, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    ang = 2.0 * np.pi * np.outer(np.arange(RADIX), np.arange(RADIX)) / N_FFT  # [k1, n2]
    filt = _basis(n_mels)[1][:, :n_mels]  # [201, n_mels] f32
    lo, off, weights = [], [0], []
    for m in range(n_mels):
        nz = np.flatnonzero(filt[:, m])
        first, last = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        lo.append(first)
        weights.append(filt[first:last, m])
        off.append(off[-1] + last - first)
    if off[-1] > MAX_NNZ:
        raise ValueError(f"{KERNEL}: {off[-1]} filterbank non-zeros > {MAX_NNZ}")
    table = np.zeros((MEL_W + MAX_NNZ,), np.float32)
    table[:N_FFT] = window
    table[TW_COS:TW_SIN] = np.cos(ang).ravel()
    table[TW_SIN:MEL_W] = np.sin(ang).ravel()
    table[MEL_W : MEL_W + off[-1]] = np.concatenate(weights)
    j = 2.0 * np.pi * np.arange(RADIX) / RADIX
    dft20 = np.concatenate([np.cos(j), np.sin(j)]).astype(np.float32)
    return table, np.asarray(lo + off, np.int32), dft20


@functools.lru_cache(maxsize=8)
def _device_plan(device: torch.device, n_mels: int) -> Tuple[torch.Tensor, torch.Tensor, ctypes.Array]:
    """:func:`_plan` for the kernel: the table and ranges on ``device``,
    uploaded once, and the 20-point table as a ctypes array (the C entry
    copies it into the kernel's parameters)."""
    table, ranges, dft20 = _plan(n_mels)
    return (torch.from_numpy(table).to(device), torch.from_numpy(ranges).to(device),
            (ctypes.c_float * dft20.size)(*dft20.tolist()))


def kernel_flops(n_mels: int) -> int:
    """Floating-point operations the kernel does per frame (an FMA counts
    2), as the note of ``csrc/log_mel_fused.cu`` counts them: the window;
    stage 1 (per column n2: 18 fold sums, 2 more, 11 real outputs of 9 FMAs,
    9 imaginary ones of a product and 8 FMAs); stage 2 (per k1: 20 complex
    twiddle products, 36 fold sums, per bin 2 sums and 18 FMAs, the power);
    the mel product over the non-zeros; the log."""
    stage1 = RADIX * (18 + 2 + 11 * 9 * 2 + 9 * (1 + 8 * 2))
    per_k1 = lambda bins: 20 * 6 + 36 + bins * (2 + 36 * 2 + 3)  # noqa: E731
    stage2 = per_k1(11) + (RADIX - 1) * per_k1(10)
    nnz = int(_plan(n_mels)[1][-1])
    return N_FFT + stage1 + stage2 + 2 * nnz + n_mels


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
    if x.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: samples must be 16-byte aligned (the kernel copies 16-byte chunks)")
    b = x.shape[0]
    table, ranges, dft20 = _device_plan(x.device, n_mels)
    out = torch.empty((b, n_mels, N_FRAMES), dtype=torch.float32, device=x.device)
    if b:
        rc = _library().log_mel_fused(
            x.data_ptr(), table.data_ptr(), ranges.data_ptr(), dft20, out.data_ptr(), b, n_mels,
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
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte chunks
        x = x.clone()
    return _epilogue(log10_mel_kernel(x, n_mels), samples.shape[:-1])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with its entry's argument types, bound once."""
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    lib.log_mel_fused.argtypes = (
        [ctypes.c_void_p] * 3  # samples, table, ranges
        + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]  # dft20 (host), out
        + [ctypes.c_int] * 3  # batch, n_mels, device
        + [ctypes.c_void_p]  # stream
    )
    lib.log_mel_fused.restype = ctypes.c_int
    return lib
