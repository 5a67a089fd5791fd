"""Cross-attention against the stored K/V in one launch a layer.

Replaces no TPU kernel: on the TPU, ``whisper_tpu/models/layers.py``'s
``cross_attention_T`` is two einsums that XLA fuses with the fp8 upcast
into their operand loads. The port ran the same function as PyTorch ops,
about nine kernels a layer that moved some six times the stored K/V
(the fp8 upcast, an f32 copy of K, an f32 score product, the softmax, the
casts); :func:`cross_attend_reference` keeps them as the plain version.

:func:`cross_attend` computes, for ``q`` [B, Tq, H, 64] bfloat16 (its last
axis contiguous) and the stored ``kT``, ``vT`` [B, H, 64, Tk] (bfloat16,
float8_e4m3fn or float8_e5m2, contiguous), the arithmetic of the plain
version with only the order of sums changed: scores as f32 sums of exact
products (every fp8 value is exact in bf16 and in f32) times 1/sqrt(64),
an f32 softmax over the whole Tk, the weights rounded to bf16, the value
product summed in f32, the output in bf16. A CPU tensor takes the plain version; a CUDA tensor
launches ``csrc/cross_attend.cu`` (kernels named ``cross_attend_*``), one
launch a call, or raises on what the kernel does not take: no fallback.

``models/layers.cross_attention_T`` sends every CUDA call with a bf16
query here (:func:`routes`), so a head size or a store the kernel does
not take raises on the card; the float32 parity dtype and CPU tensors
keep the plain version.

The launch plan (:func:`plan`) picks the kernel's variant from the
shapes: 8 queries a block up to 8 queries a row, else 16, the blocks of
one (row, head) tiling the queries; keys a load, 4 where Tk and both
bases allow an aligned load of 4 keys, else 2, else 1. The shared-memory
layout (the scores' row pitch, the shared bytes a block) is the kernel's
own: its C entry derives it from the query tile and Tk, and refuses a Tk
whose row of scores does not fit a block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

KERNEL = "cross_attend"
KERNEL_SYMBOL = "cross_attend"  # the prefix of its kernels' names in a profiler trace
HEAD_DIM = 64
STORES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
TOO_LONG = -1  # the C entry's return where Tk's scores do not fit a block's shared memory

# Launches of the CUDA kernel in this process (the plain version counts
# nothing; a replayed graph adds what its capture launched).
launches = 0


class Plan(NamedTuple):
    qn: int  # query tiles of 8 · qn
    kpl: int  # keys a load


def cross_attend_reference(q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
    """Plain version: fp8 K/V upcast to the query's dtype, f32 scores from
    f32 copies of q and K times 1/sqrt(Dh), an f32 softmax, the weights cast
    to V's dtype for the value product. q [B, Tq, H, Dh], kT and vT [B, H,
    Dh, Tk] → [B, Tq, H, Dh]."""
    if kT.element_size() == 1:
        kT = kT.to(q.dtype)
    if vT.element_size() == 1:
        vT = vT.to(q.dtype)
    dh = q.shape[-1]
    qt = q.transpose(1, 2)  # [B, H, Tq, Dh]
    scores = torch.matmul(qt.float(), kT.float()) * (1.0 / float(dh) ** 0.5)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(vT.dtype), vT.transpose(-1, -2))  # [B, H, Tq, Dh]
    return out.transpose(1, 2).to(vT.dtype)


def routes(q: torch.Tensor) -> bool:
    """Whether ``models/layers.cross_attention_T`` sends a CUDA call here: a
    bf16 query (:func:`cross_attend` raises on what else it does not take)."""
    return q.dtype == torch.bfloat16


def _keys_per_load(tk: int, itemsize: int, *ptrs: int) -> int:
    for kpl in (4, 2):
        if tk % kpl == 0 and all(p % (kpl * itemsize) == 0 for p in ptrs):
            return kpl
    return 1


def plan(tq: int, tk: int, itemsize: int, k_ptr: int = 0, v_ptr: int = 0) -> Plan:
    """The kernel's variant for ``tq`` queries a row and ``tk`` keys stored
    at ``itemsize`` bytes from the addresses ``k_ptr`` and ``v_ptr``
    (module docstring)."""
    return _plan(tq, tk, itemsize, k_ptr % 8, v_ptr % 8)  # a load is at most 8 bytes


@functools.lru_cache(maxsize=256)
def _plan(tq: int, tk: int, itemsize: int, k_ptr: int, v_ptr: int) -> Plan:
    return Plan(1 if tq <= 8 else 2, _keys_per_load(tk, itemsize, k_ptr, v_ptr))


def _check(q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor) -> None:
    if (q.dtype == torch.bfloat16 and kT.dtype in STORES and vT.dtype == kT.dtype and q.dim() == 4
            and q.shape[3] == HEAD_DIM and kT.dim() == 4 and vT.shape == kT.shape
            and kT.shape[:3] == (q.shape[0], q.shape[2], HEAD_DIM) and q.stride(3) == 1
            and kT.is_contiguous() and vT.is_contiguous() and q.device == kT.device == vT.device):
        return  # the common case in one test; what follows names the fault
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{KERNEL}: takes a bfloat16 query, got {q.dtype}")
    if kT.dtype not in STORES or vT.dtype != kT.dtype:
        raise ValueError(f"{KERNEL}: K and V must both be one of {sorted(map(str, STORES))}, "
                         f"got {kT.dtype} and {vT.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{KERNEL}: q must be [B, Tq, H, {HEAD_DIM}], got {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if kT.dim() != 4 or tuple(kT.shape[:3]) != (b, h, dh) or vT.shape != kT.shape:
        raise ValueError(f"{KERNEL}: K and V must be [B, H, Dh, Tk] = [{b}, {h}, {dh}, Tk] in the "
                         f"stored layout, got {tuple(kT.shape)} and {tuple(vT.shape)}")
    if q.stride(-1) != 1:
        raise ValueError(f"{KERNEL}: q's head dim must be contiguous, got strides {q.stride()}")
    for name, t in (("K", kT), ("V", vT)):
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous, got strides {t.stride()}")
    raise ValueError(f"{KERNEL}: q, K and V on {q.device}, {kT.device}, {vT.device}")


def cross_attend(q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
    """``q`` [B, Tq, H, 64] bfloat16 against ``kT``, ``vT`` [B, H, 64, Tk]
    (one dtype of :data:`STORES`, contiguous) → [B, Tq, H, 64] bfloat16.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    _check(q, kT, vT)
    if q.device.type == "cpu":
        return cross_attend_reference(q, kT, vT)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {q.device}")
    b, tq, h, dh = q.shape
    tk = kT.shape[-1]
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    if tk == 0:
        raise ValueError(f"{KERNEL}: no keys (Tk 0)")
    p = plan(tq, tk, kT.element_size(), kT.data_ptr(), vT.data_ptr())
    rc = _library().cross_attend(
        q.data_ptr(), kT.data_ptr(), vT.data_ptr(), out.data_ptr(), *q.stride()[:3], b, tq, h, tk,
        STORES[kT.dtype], p.qn, p.kpl, 1.0 / float(dh) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc == TOO_LONG:
        raise ValueError(f"{KERNEL}: Tk {tk} at {tq} queries a row: the scores do not fit a block's "
                         "shared memory")
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.cross_attend.argtypes = [ptr] * 4 + [ctypes.c_int64] * 3 + [i] * 7 + [ctypes.c_float, ptr]
    lib.cross_attend.restype = i
    return lib
