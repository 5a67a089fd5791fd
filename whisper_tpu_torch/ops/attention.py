"""Fused (flash) self-attention for the encoder's 1500-position sequence (K1).

Counterpart of ``whisper_tpu/ops/attention.py``. There the TPU runs JAX's
Pallas ``flash_attention`` on inputs padded to a multiple of 512 with a
segment-id mask. Here a CUDA tensor runs the hand-written Hopper kernel
``csrc/flash_attn_fwd.cu``, which tiles T as it is and masks the ragged
last K/V tile itself. A CPU tensor runs :func:`fused_self_attention_reference`,
the plain PyTorch version of the same function. There is no fallback: a
CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_tpu_torch.models import layers

KERNEL = "flash_attn_fwd"
KERNEL_SYMBOL = "flash_fwd"  # in the names of its device functions (profiler traces)
HEAD_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


def fused_self_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``softmax(q kᵀ / sqrt(Dh)) v`` on [B, T, H, Dh] —
    ``layers.qkv_attention`` without a mask, as in JAX: f32 scores times
    1/sqrt(Dh), f32 softmax, weights cast to ``v.dtype`` for the value
    product, output in ``v.dtype``."""
    return layers.qkv_attention(q, k, v, mask=None)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"{KERNEL}: q, k, v must share one [B, T, H, Dh] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{KERNEL}: dtype must be float32 or bfloat16 for all of q, k, v, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{KERNEL}: q, k, v on different devices")
    # 16-byte vector loads: contiguous head_dim, 16-byte aligned rows.
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{KERNEL}: {name} head_dim axis must be contiguous")
        if x.data_ptr() % 16 or any(s % align for s in x.stride()[:3]):
            raise ValueError(f"{KERNEL}: {name} rows must be 16-byte aligned")


def fused_self_attention(
    q: torch.Tensor,  # [B, T, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Unmasked self-attention with Whisper scaling (combined 1/sqrt(Dh)).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if q.device.type == "cpu":
        return fused_self_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {q.device}")
    _check(q, k, v)
    b, t, h, dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = _library().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, dh, _DTYPE_CODE[q.dtype], strides,
        1.0 / float(dh) ** 0.5, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    fn = lib.flash_attn_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
