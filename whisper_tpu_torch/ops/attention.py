"""Fused (flash) self-attention for the encoder's 1500-position sequence (K1).

Counterpart of ``whisper_tpu/ops/attention.py``. There the TPU runs JAX's
Pallas ``flash_attention`` on inputs padded to a multiple of 512 with a
segment-id mask. Here a CUDA tensor runs the hand-written Hopper kernel
``csrc/flash_attn_fwd.cu``, which tiles T as it is and masks the ragged
last K/V tile itself. Its bf16 body: TMA loads, ``wgmma``, a producer
warpgroup and three consumer warpgroups on a persistent grid. Its f32 body
(the parity dtype; FMA on the CUDA cores, no TF32): register tiles of 4 rows
x 8 keys of S and 4 rows x 8 columns of O per lane, one softmax update and
one exp2 per score per 64-key tile, K and V tiles by bulk copies on
mbarriers, and a launch shaped to the card's waves (:func:`f32_plan`). A
CPU tensor runs :func:`fused_self_attention_reference`, the plain PyTorch
version of the same function. There is no fallback: a CUDA tensor the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from whisper_tpu_torch.models import layers

KERNEL = "flash_attn_fwd"
KERNEL_SYMBOL = "flash_fwd"  # in the names of its device functions (profiler traces)
HEAD_DIMS = (32, 64)
BLOCK_ROWS = 64  # rows of one TMA box: a warpgroup's query rows, half a K/V tile
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
    # TMA (bf16) and one bulk copy per row (f32): contiguous head_dim,
    # 16-byte aligned base and strides.
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{KERNEL}: {name} head_dim axis must be contiguous")
        if x.data_ptr() % 16 or any(s % align for s in x.stride()[:3]):
            raise ValueError(f"{KERNEL}: {name} rows must be 16-byte aligned")


def tensor_map_layout(
    shape: Sequence[int], strides: Sequence[int], itemsize: int
) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """The 4-D TMA tensor map of a [B, T, H, Dh] view, as the kernel's
    ``cuTensorMapEncodeTiled`` takes it: dims innermost first ``(Dh, H, T,
    B)``, the byte strides of H, T and B, and the box ``(Dh, 1, BLOCK_ROWS,
    1)`` (one head's BLOCK_ROWS consecutive positions; the kernel refuses
    any other box). A size-1 axis gets the stride it would have if the dims
    were packed (its stride is never used; TMA wants one that is a multiple
    of 16 bytes). Raises ``ValueError`` for a head axis that is not
    contiguous or a byte stride that is not a multiple of 16."""
    b, t, h, dh = (int(n) for n in shape)
    if int(strides[3]) != 1:
        raise ValueError(f"{KERNEL}: head_dim axis must be contiguous, stride {strides[3]}")
    dims = (dh, h, t, b)
    byte_strides = []
    packed = dh * itemsize
    for size, stride in ((h, strides[2]), (t, strides[1]), (b, strides[0])):
        step = packed if size == 1 else int(stride) * itemsize
        if step % 16:
            raise ValueError(
                f"{KERNEL}: byte stride {step} of a [B, T, H, Dh] view is not a multiple of 16"
            )
        byte_strides.append(step)
        packed = step * size
    return dims, tuple(byte_strides), (dh, 1, BLOCK_ROWS, 1)


@functools.lru_cache(maxsize=64)
def _layouts(shape, q_strides, k_strides, v_strides, itemsize) -> ctypes.Array:
    """The tensor-map layouts of q, k and v as the C entry takes them (33
    values), kept per shape and strides: the encoder asks for the same ones
    in every layer, and building them in Python was most of the wrapper's
    host time. The C side only reads the array."""
    flat = [n for strides in (q_strides, k_strides, v_strides)
            for part in tensor_map_layout(shape, strides, itemsize) for n in part]
    return (ctypes.c_uint64 * len(flat))(*flat)


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
    layouts = None
    if q.dtype == torch.bfloat16:
        layouts = _layouts(tuple(q.shape), q.stride(), k.stride(), v.stride(), q.element_size())
    rc = _library().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, dh, _DTYPE_CODE[q.dtype], strides, layouts,
        1.0 / float(dh) ** 0.5, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL}: launch failed with code {rc} (a cudaError_t, or 1000 + the "
            "CUresult of a tensor-map encode)"
        )
    launches += 1
    return out


def f32_plan(b: int, t: int, h: int, dh: int, device: int = 0) -> Tuple[int, int, int]:
    """The f32 body's launch on the card for [b, t, h, dh]: (warps per CTA,
    CTAs resident per SM, registers per thread), as the kernel's wave model
    picks them."""
    out = (ctypes.c_int * 3)()
    rc = _library().flash_attn_f32_plan(b, t, h, dh, device, out)
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: f32 launch plan failed with code {rc} (a cudaError_t)")
    return out[0], out[1], out[2]


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    fn = lib.flash_attn_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    plan = lib.flash_attn_f32_plan
    plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    return lib
