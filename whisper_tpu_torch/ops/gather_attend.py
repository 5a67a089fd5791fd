"""Fused gather + append + single-query attention on ping-pong KV planes (K3).

Counterpart of ``fused_gather_attend`` in ``whisper_tpu/ops/fused_step.py:328``
(the Pallas kernel ``_kernel`` plus its XLA epilogue). One call, for one
decoder layer, does what K2 (``ops/fused_step.permute_append``) does to the
plane pair ``[2, L, BK, ctx, HD]`` (HD = H·Dh) and, in the same pass over
the gathered bytes, the self-attention of each row's query over positions
``[0, pos)``; the new row's own term at ``pos`` is merged by an exact online
softmax. A CUDA tensor runs the hand-written kernel ``csrc/gather_attend.cu``;
a CPU tensor runs :func:`fused_gather_attend_reference`, the plain version.
There is no fallback: a CUDA tensor the kernel does not take raises.

Plane semantics are K2's: the read plane ``parity`` is never written; in
the write plane ``1 - parity``, rows ``[0, pos)`` are the read plane's rows
``idx[b]`` moved as raw bytes and row ``pos`` holds the new rows cast to the
storage dtype with torch's ``.to``, so the plane bytes equal K2's. The
CUDA kernel casts the new rows itself, bitwise as ``.to()``, from the pairs
of dtypes in ``ops/fused_step.CAST_PAIRS`` (K2's, ``csrc/store_cast.cuh``)
and at any strides, so a call is one launch. Past ``pos`` the write plane
is unspecified. The planes are updated in place and returned.

Arithmetic is JAX's kernel plus epilogue: the gathered K/V are cast to q's
dtype; scores are f32 products times Dh^-½; per (row, head) the max ``m`` and
``l = Σ exp(s − m)`` in f32; the weights ``exp(s − m)`` are cast to q's dtype
and the value sum is taken in f32, unnormalized; then the self term (the
stored new rows read back in f32) merges as ``m2 = max(m, s_self)``,
``alpha = exp(m − m2)``, ``beta = exp(s_self − m2)``,
``(attn_u·alpha + beta·v_new) / (l·alpha + beta)``, cast to q's dtype. At
``pos == 0`` there are no prior rows: ``m = −inf``, so ``alpha`` is 0 exactly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from whisper_tpu_torch.models import layers
from whisper_tpu_torch.ops.fused_step import CAST_PAIRS, DTYPE_CODES, e4m3_saturates, permute_append_reference

KERNEL = "gather_attend"
KERNEL_SYMBOL = "gather_attend_kernel"  # in the names of its device functions (profiler traces)
STORAGE_DTYPES = (torch.float8_e4m3fn, torch.bfloat16, torch.float32)  # the planes the kernel reads
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)  # q and attn
_VEC = 16  # bytes per vector load and store in the kernel
_MAX_HEAD_BYTES = 512  # a head's slice of a position: at most 32 vectors
_THREADS = 128  # per block (csrc/gather_attend.cu kThreads)
_REG_PASSES = 4  # window passes the kernel holds in registers (kRegPasses)
_SHARED_BYTES = 227 * 1024  # shared memory a block may use on the H100

# Launches of the CUDA kernel in this process (plain version not counted).
launches = 0


def supported(hd: int, itemsize: int, n_head: int) -> bool:
    """Whether the CUDA kernel takes a merged head dim ``hd`` of ``n_head``
    heads stored in ``itemsize``-byte elements: one head's slice of a cache
    position must be a power-of-two count of 16-byte vectors, at most 32
    (the threads that share a position reduce their partial scores within
    one warp)."""
    if hd % n_head:
        return False
    head_bytes = hd // n_head * itemsize
    vecs = head_bytes // _VEC
    return head_bytes % _VEC == 0 and 0 < vecs and vecs & (vecs - 1) == 0 and head_bytes <= _MAX_HEAD_BYTES


def _check(cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, n_head) -> None:
    if cache_k.dim() != 5 or cache_k.shape[0] != 2:
        raise ValueError(f"{KERNEL}: planes must be [2, L, BK, ctx, HD], got {tuple(cache_k.shape)}")
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"{KERNEL}: K and V planes differ in shape or dtype")
    _, n_layer, bk, ctx, hd = cache_k.shape
    if hd % n_head:
        raise ValueError(f"{KERNEL}: HD {hd} is not a multiple of n_head {n_head}")
    if idx.shape != (bk,) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{KERNEL}: idx must be [BK={bk}] integers, got {tuple(idx.shape)} {idx.dtype}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (bk, hd):
            raise ValueError(f"{KERNEL}: {name} must be [{bk}, {hd}], got {tuple(t.shape)}")
    if not q.is_floating_point():
        raise TypeError(f"{KERNEL}: q must be a float tensor, got {q.dtype}")
    if not (0 <= layer < n_layer and 0 <= pos < ctx and parity in (0, 1)):
        raise ValueError(f"{KERNEL}: layer {layer}, pos {pos}, parity {parity} out of range")
    devices = {t.device for t in (cache_k, cache_v, idx, q, k_new, v_new)}
    if len(devices) != 1:
        raise ValueError(f"{KERNEL}: operands on several devices: {devices}")


def _merge_self_term(attn_u, m, l, q, kc, vc, n_head: int) -> torch.Tensor:
    """JAX's epilogue (``fused_step.py:451-467``): fold the new row's own
    term into the unnormalized attention over ``[0, pos)``. ``attn_u`` [BK,
    H, Dh] f32, ``m`` and ``l`` [BK, H] f32, ``kc``/``vc`` the new rows in
    the storage dtype."""
    bk, hd = q.shape
    dh = hd // n_head
    scale = float(dh) ** -0.5
    qf = q.float().reshape(bk, n_head, dh)
    s_self = (qf * kc.float().reshape(bk, n_head, dh)).sum(-1) * scale
    m2 = torch.maximum(m, s_self)
    alpha = torch.exp(m - m2)[..., None]
    beta = torch.exp(s_self - m2)[..., None]
    denom = l[..., None] * alpha + beta
    attn = (attn_u * alpha + beta * vc.float().reshape(bk, n_head, dh)) / denom
    return attn.reshape(bk, hd).to(q.dtype)


def fused_gather_attend_reference(
    cache_k: torch.Tensor, cache_v: torch.Tensor, idx: torch.Tensor,
    layer: int, pos: int, parity: int, q: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, *, n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: K2's plain version for the planes, then the kernel's
    arithmetic (module docstring) in plain torch."""
    _check(cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, n_head)
    permute_append_reference(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    bk, hd = q.shape
    dh = hd // n_head
    w = 1 - parity
    if pos == 0:
        attn_u = q.new_zeros((bk, n_head, dh), dtype=torch.float32)
        m = q.new_full((bk, n_head), float("-inf"), dtype=torch.float32)
        l = q.new_zeros((bk, n_head), dtype=torch.float32)
    else:
        k, v = (
            p[w, layer, :, :pos].to(q.dtype).float().reshape(bk, pos, n_head, dh)
            for p in (cache_k, cache_v)
        )
        scores = torch.einsum("bhd,bphd->bhp", q.float().reshape(bk, n_head, dh), k)
        scores = scores * (float(dh) ** -0.5)
        m = scores.amax(dim=-1)
        e = torch.exp(scores - m[..., None])
        l = e.sum(dim=-1)
        attn_u = torch.einsum("bhp,bphd->bhd", e.to(q.dtype).float(), v)
    kc, vc = (p[w, layer, :, pos] for p in (cache_k, cache_v))
    return _merge_self_term(attn_u, m, l, q, kc, vc, n_head), cache_k, cache_v


def reference_gather_attend(
    cache_k: torch.Tensor, cache_v: torch.Tensor, idx: torch.Tensor,
    layer: int, pos: int, parity: int, q: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, *, n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counterpart of JAX's oracle ``reference_gather_attend``
    (``fused_step.py:470``): K2's plain version, then one
    ``layers.qkv_attention`` over the written window ``[0, pos]`` — what
    the port's hybrid step runs per layer."""
    _check(cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, n_head)
    permute_append_reference(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    bk, hd = q.shape
    dh = hd // n_head
    k, v = (p[1 - parity, layer, :, : pos + 1].view(bk, pos + 1, n_head, dh) for p in (cache_k, cache_v))
    out = layers.qkv_attention(q.reshape(bk, 1, n_head, dh), k, v, None)
    return out.reshape(bk, hd), cache_k, cache_v


def fused_gather_attend(
    cache_k: torch.Tensor,  # [2, L, BK, ctx, HD] storage dtype
    cache_v: torch.Tensor,
    idx: torch.Tensor,  # [BK] int32 destination → source rows (duplicates allowed)
    layer: int,
    pos: int,  # the new rows land at this position; the query attends [0, pos]
    parity: int,  # read plane; the write plane is 1 - parity
    q: torch.Tensor,  # [BK, HD] compute dtype (bfloat16 or float32)
    k_new: torch.Tensor,  # [BK, HD] new rows, any strides; on CUDA a pair of CAST_PAIRS
    v_new: torch.Tensor,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's pending-permutation attention step, in place. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one launch
    covers K, V, every head and the new rows' cast). Returns (attn [BK, HD]
    in q.dtype, cache_k, cache_v)."""
    global launches
    if cache_k.device.type == "cpu":
        return fused_gather_attend_reference(
            cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, n_head=n_head
        )
    if cache_k.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {cache_k.device}")
    qc = q.contiguous()
    out = torch.empty_like(qc)
    rc = _library().gather_attend(
        *_kernel_args(cache_k, cache_v, idx, layer, pos, parity, qc, k_new, v_new, out, n_head),
        cache_k.device.index or 0, torch.cuda.current_stream(cache_k.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 1
    return out, cache_k, cache_v


def _shared_bytes(pos: int, hd: int, itemsize: int, n_head: int) -> int:
    """Shared memory a block of the kernel needs: its static value sums, the
    scores of the window, and the V window itself where it passes
    ``_REG_PASSES`` passes (csrc/gather_attend.cu ``launch``)."""
    head_vecs = hd // n_head * itemsize // _VEC
    per_pass = _THREADS // head_vecs
    static = (_THREADS // 32 + 2) * _MAX_HEAD_BYTES * 4  # the warps' value sums, the new rows
    dynamic = -(-pos // 4) * 16 + 16
    if -(-pos // per_pass) > _REG_PASSES:
        dynamic += pos * head_vecs * _VEC
    return static + dynamic


def _kernel_args(cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, out, n_head) -> tuple:
    """Check the operands of a CUDA launch and return the C entry's
    arguments up to ``scale``; raises where the kernel does not take them.
    The new rows go as they are: pointer, row stride in bytes, element
    stride, dtype code (``ops/fused_step.DTYPE_CODES``, K2's)."""
    _check(cache_k, cache_v, idx, layer, pos, parity, q, k_new, v_new, n_head)
    _, n_layer, bk, ctx, hd = cache_k.shape
    isz = cache_k.element_size()
    if cache_k.dtype not in STORAGE_DTYPES or q.dtype not in COMPUTE_DTYPES:
        raise TypeError(
            f"{KERNEL}: storage must be float8_e4m3fn, bfloat16 or float32 and q bfloat16 or "
            f"float32, got {cache_k.dtype} and {q.dtype}"
        )
    if v_new.dtype != k_new.dtype or (k_new.dtype, cache_k.dtype) not in CAST_PAIRS:
        raise TypeError(
            f"{KERNEL}: no conversion of {k_new.dtype} / {v_new.dtype} rows into "
            f"{cache_k.dtype} planes on CUDA"
        )
    if not supported(hd, isz, n_head):
        raise ValueError(
            f"{KERNEL}: a head's slice of a position ({hd // n_head * isz} bytes) must be a "
            f"power-of-two count of {_VEC}-byte vectors, at most {_MAX_HEAD_BYTES} bytes"
        )
    if _shared_bytes(pos, hd, isz, n_head) > _SHARED_BYTES:
        raise ValueError(f"{KERNEL}: the window at pos {pos} does not fit in a block's shared memory")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(f"{KERNEL}: on CUDA idx must be contiguous int32, got {idx.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if not t.is_contiguous() or t.data_ptr() % _VEC:
            raise ValueError(f"{KERNEL}: {name} must be contiguous and 16-byte aligned")
    if not q.is_contiguous() or out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"{KERNEL}: q must be contiguous and out like it")
    rsz = k_new.element_size()
    return (
        cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_new.stride(0) * rsz, k_new.stride(1), v_new.stride(0) * rsz, v_new.stride(1),
        DTYPE_CODES[k_new.dtype], rsz, DTYPE_CODES[cache_k.dtype], int(e4m3_saturates()),
        idx.data_ptr(), q.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
        n_layer, bk, ctx, hd, n_head, int(layer), int(pos), int(parity), float(hd // n_head) ** -0.5,
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with its entry's argument types, bound once."""
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    lib.gather_attend.argtypes = (
        [ctypes.c_void_p] * 4  # planes K, V; new rows K, V
        + [ctypes.c_int64] * 4  # row and element strides of the new rows
        + [ctypes.c_int] * 4  # row dtype, row itemsize, storage dtype, e4m3_saturates
        + [ctypes.c_void_p] * 3  # idx, q, out
        + [ctypes.c_int] * 9  # compute dtype, n_layer, bk, ctx, hd, n_head, layer, pos, parity
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, device, stream
    )
    lib.gather_attend.restype = ctypes.c_int
    return lib
