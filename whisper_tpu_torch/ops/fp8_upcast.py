"""fp8 → bf16 streaming upcast of a contiguous plane (K6).

Counterpart of ``dma_upcast`` in ``tools/probe_cross.py:119``. There the
TPU runs a Pallas kernel that streams one layer's cross K or V plane
``[B·H·Dh, Tk]`` through VMEM, two 64-row chunks in flight, and casts it to
bf16 in an HBM scratch; the probe's ``dmastage`` formulation calls it on
every layer's K and V. Here ``utils/probe_cross.py``'s ``dmastage`` calls
:func:`dma_upcast`: a CUDA tensor runs the hand-written kernel
``csrc/fp8_upcast.cu``, a CPU tensor runs :func:`dma_upcast_reference`, the
plain version. Every float8_e4m3fn and float8_e5m2 value is exact in bf16,
so both give ``x.to(torch.bfloat16)`` bitwise (NaN codes NaN). There is no
fallback: a CUDA tensor the kernel does not take raises.

The wrapper refuses, on either device, another dtype (the TPU kernel's
2-byte store is a plain copy, which the probe's ``dmastage`` does not
port), a non-contiguous tensor and a base address that is not 16-byte
aligned (the kernel reads 16 values per 16-byte load).
"""

from __future__ import annotations

import ctypes

import torch

KERNEL = "fp8_upcast"
KERNEL_SYMBOL = "fp8_upcast_kernel"  # in the names of its device functions (profiler traces)
_VEC = 16  # bytes per vector load in the kernel
_E5M2 = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _E5M2:
        raise ValueError(f"{KERNEL}: takes float8_e4m3fn or float8_e5m2, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{KERNEL}: the input must be contiguous, got strides {x.stride()}")
    if x.data_ptr() % _VEC:
        raise ValueError(f"{KERNEL}: the input's base address must be {_VEC}-byte aligned")


def dma_upcast_reference(x2d: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x2d.to(torch.bfloat16)``."""
    return x2d.to(torch.bfloat16)


def dma_upcast(x2d: torch.Tensor) -> torch.Tensor:
    """``x2d`` (a contiguous fp8 tensor of any shape, e.g. a layer's
    ``[B·H·Dh, Tk]`` plane) as bf16 in a new tensor of the same shape. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    _check(x2d)
    if x2d.device.type == "cpu":
        return dma_upcast_reference(x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {x2d.device}")
    out = torch.empty(x2d.shape, dtype=torch.bfloat16, device=x2d.device)
    if x2d.numel() == 0:
        return out
    rc = _library().fp8_upcast(
        x2d.data_ptr(), out.data_ptr(), x2d.numel(), _E5M2[x2d.dtype], x2d.device.index or 0,
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    fn = lib.fp8_upcast
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
