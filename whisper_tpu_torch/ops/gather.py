"""Row permutation of a stacked cache, ``out[l, n] = x[l, idx[n]]`` (K4).

Counterpart of ``whisper_tpu/ops/gather.py``. There the TPU runs a Pallas
block-copy kernel whose source row comes from a scalar-prefetched index;
the JAX package reaches it from ``reorder_cache(use_pallas=True)``. Here
every beam cache reorder of a CUDA tensor runs the hand-written kernel
``csrc/permute_rows.cu``, and a CPU tensor runs
:func:`permute_rows_reference`, the plain version. Both move raw bytes, so
every dtype (fp8 included) is permuted bitwise. There is no fallback: a
CUDA tensor the kernel does not take raises.

The permutation is out of place: rows repeat (beam branching), so writing
into ``x`` itself would overwrite rows still to be read. The caller passes
``out=`` (a second buffer, or a window view of one) or gets a new tensor.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

KERNEL = "permute_rows"
KERNEL_SYMBOL = "permute_rows_kernel"  # in the names of its device functions (profiler traces)
_VEC = 16  # bytes per vector load and store in the kernel

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


def _row_bytes(x: torch.Tensor) -> int:
    return math.prod(x.shape[2:]) * x.element_size()


def supported(x: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes ``x``'s geometry: rows of whole
    16-byte vectors."""
    return x.dim() >= 3 and _row_bytes(x) % _VEC == 0


def _rows_contiguous(x: torch.Tensor) -> bool:
    """Each x[l, n] is one contiguous run of memory."""
    expected = 1
    for size, stride in reversed(list(zip(x.shape[2:], x.stride()[2:]))):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _check(x: torch.Tensor, idx: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if x.dim() < 3:
        raise ValueError(f"{KERNEL}: x must be [L, N, ...], got {tuple(x.shape)}")
    if idx.dim() != 1 or idx.shape[0] != x.shape[1]:
        raise ValueError(f"{KERNEL}: idx must be [N={x.shape[1]}], got {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{KERNEL}: idx must be an integer tensor, got {idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"{KERNEL}: idx on {idx.device}, x on {x.device}")
    if out is not None:
        if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
            raise ValueError(
                f"{KERNEL}: out must match x ({tuple(x.shape)} {x.dtype} {x.device}), "
                f"got {tuple(out.shape)} {out.dtype} {out.device}"
            )
        if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            raise ValueError(f"{KERNEL}: out shares x's storage; rows repeat, so it cannot run in place")


def _check_cuda(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(f"{KERNEL}: on CUDA idx must be contiguous int32, got {idx.dtype}")
    if not supported(x):
        raise ValueError(f"{KERNEL}: row of {_row_bytes(x)} bytes is not a multiple of {_VEC}")
    isz = x.element_size()
    for name, t in (("x", x), ("out", out)):
        if not _rows_contiguous(t):
            raise ValueError(f"{KERNEL}: each row of {name} must be contiguous")
        if t.data_ptr() % _VEC or any(s * isz % _VEC for s in t.stride()[:2]):
            raise ValueError(f"{KERNEL}: rows of {name} must be 16-byte aligned")


def permute_rows_reference(
    x: torch.Tensor, idx: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version: ``out[l, n] = x[l, idx[n]]`` as a byte gather (a
    ``torch.uint8`` view, so fp8 and every other dtype move bitwise)."""
    _check(x, idx, out)
    rows = x.view(torch.uint8).index_select(1, idx.long())
    if out is None:
        return rows.view(x.dtype)
    out.view(torch.uint8).copy_(rows)
    return out


def permute_rows(
    x: torch.Tensor,  # [L, N, ...] any dtype
    idx: torch.Tensor,  # [N] destination → source rows, duplicates allowed
    out: Optional[torch.Tensor] = None,  # [L, N, ...] like x, not overlapping it
) -> torch.Tensor:
    """``out[l, n] = x[l, idx[n]]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel. ``x`` and ``out`` may be strided views (e.g.
    a window ``cache[:, :, :w]``) as long as each row is contiguous."""
    global launches
    if x.device.type == "cpu":
        return permute_rows_reference(x, idx, out)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {x.device}")
    _check(x, idx, out)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _check_cuda(x, idx, out)
    if x.numel() == 0:
        return out
    v = x.element_size()
    rc = _library().permute_rows(
        x.data_ptr(), out.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1],
        x.stride(0) * v // _VEC, x.stride(1) * v // _VEC,
        out.stride(0) * v // _VEC, out.stride(1) * v // _VEC,
        _row_bytes(x) // _VEC, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    fn = lib.permute_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
