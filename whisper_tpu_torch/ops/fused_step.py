"""Pending beam permutation plus append on ping-pong KV planes (K2), and
the same on one data shard of a mesh (K2′).

Counterpart of ``permute_append`` and ``permute_append_sharded`` in
``whisper_tpu/ops/fused_step.py``, the kernels of the beam step mode
``"hybrid"`` (``models/decoder.py`` ``decoder_step_fused``). The cache is a
plane pair ``[2, L, BK, ctx, HD]`` (HD = H·Dh) in its storage dtype; one
call, for one layer, makes the write plane ``1 - parity`` the read plane
``parity`` gathered by ``idx`` (the beam permutation chosen at the
previous step) with this step's new K/V rows at ``pos``, cast to the
storage dtype. K2′ is K2 on a rank of a data-parallel mesh: the planes hold
the rank's rows, ``idx`` their global source rows, made local in the
kernel. A CUDA tensor runs the hand-written kernels of
``csrc/permute_append.cu``, one launch per call: the kernel converts the
new rows itself, bitwise as ``.to()`` (``csrc/store_cast.cuh``), from
the pairs of dtypes in :data:`CAST_PAIRS` and at any strides. A CPU tensor
runs :func:`permute_append_reference` or
:func:`permute_append_sharded_reference`, the plain versions. There is no
fallback: a CUDA tensor the kernel does not take raises.

Only the window ``[0, pos]`` of the write plane is written: the positions
past ``pos`` are unspecified, as in the JAX contract, and the decoder reads
``[0, pos]`` only. The JAX kernel copies whole rows. The planes are updated
in place and returned.

K2's ``pos`` may be a one-element int64 tensor on the planes' device, for
a decode step captured as a CUDA graph (``decode/graph.py``), where a
launch argument would be fixed at capture: the kernel then reads the
position on the card (its grid covers the longest window the planes
hold, and blocks past the window copy nothing; a position outside the
planes traps), and the plain version reads it on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

KERNEL = "permute_append"  # the library both kernels live in (csrc/permute_append.cu)
KERNEL_SYMBOL = "permute_append_kernel"  # in the names of its device functions (profiler traces)
SHARDED_KERNEL = "permute_append_sharded"
SHARDED_KERNEL_SYMBOL = "permute_append_sharded_kernel"
_VEC = 16  # bytes per vector load and store in the kernel

# Dtype codes of csrc/store_cast.cuh: the storage dtypes the kernel writes.
DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
    torch.float8_e4m3fn: 3, torch.float8_e5m2: 4,
}
ROW_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # converted in the kernel
# (new rows' dtype, storage dtype) pairs the CUDA kernel takes: a float row
# into any storage dtype, or a row already in the storage dtype (raw bytes).
CAST_PAIRS = frozenset(
    {(r, s) for s in DTYPE_CODES for r in ROW_DTYPES} | {(s, s) for s in DTYPE_CODES}
)

# Launches of each CUDA kernel in this process (plain versions not counted).
launches = 0  # K2
sharded_launches = 0  # K2′


def supported(hd: int, itemsize: int) -> bool:
    """Whether the CUDA kernel takes a merged head dim ``hd`` stored in
    ``itemsize``-byte elements: a cache position must be whole 16-byte
    vectors."""
    return hd * itemsize % _VEC == 0


def _check(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new) -> None:
    """Raise where the operands are not K2's. A device position is checked
    for its type and place here (at capture, in a CUDA graph) and for its
    range by the kernel."""
    if cache_k.dim() != 5 or cache_k.shape[0] != 2:
        raise ValueError(f"{KERNEL}: planes must be [2, L, BK, ctx, HD], got {tuple(cache_k.shape)}")
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"{KERNEL}: K and V planes differ in shape or dtype")
    _, n_layer, bk, ctx, hd = cache_k.shape
    if idx.shape != (bk,) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{KERNEL}: idx must be [BK={bk}] integers, got {tuple(idx.shape)} {idx.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (bk, hd):
            raise ValueError(f"{KERNEL}: {name} must be [{bk}, {hd}], got {tuple(t.shape)}")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1:
            raise ValueError(
                f"{KERNEL}: a device pos must be one int64, got {tuple(pos.shape)} {pos.dtype}"
            )
        pos_ok = ctx > 0
    else:
        pos_ok = 0 <= pos < ctx
    if not (0 <= layer < n_layer and pos_ok and parity in (0, 1)):
        raise ValueError(f"{KERNEL}: layer {layer}, pos {pos}, parity {parity} out of range")
    for t in (cache_v, idx, k_new, v_new) + ((pos,) if isinstance(pos, torch.Tensor) else ()):
        if t.device != cache_k.device:
            raise ValueError(f"{KERNEL}: operands on several devices: {cache_k.device}, {t.device}")


def _check_beam(cache_k, beam: int) -> None:
    bk = cache_k.shape[2] if cache_k.dim() == 5 else -1
    if beam < 1 or bk % beam:
        raise ValueError(
            f"{SHARDED_KERNEL}: the shard's {bk} rows are not whole samples of beam {beam}"
        )


def permute_append_reference(
    cache_k: torch.Tensor, cache_v: torch.Tensor, idx: torch.Tensor,
    layer: int, pos: int, parity: int, k_new: torch.Tensor, v_new: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, on ``torch.uint8`` views so that every storage dtype
    moves bitwise: rows ``[0, pos)`` gathered from the read plane, the new
    rows (cast to the storage dtype) at ``pos`` (a tensor's value, read on
    the host)."""
    _check(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    pos = int(pos)
    if not 0 <= pos < cache_k.shape[3]:
        raise ValueError(f"{KERNEL}: pos {pos} out of range")
    for planes, new in ((cache_k, k_new), (cache_v, v_new)):
        raw = planes.view(torch.uint8)
        raw[1 - parity, layer, :, :pos] = raw[parity, layer, :, :pos].index_select(0, idx.long())
        raw[1 - parity, layer, :, pos] = new.to(planes.dtype).view(torch.uint8)
    return cache_k, cache_v


def localize(idx_block: torch.Tensor, beam: int) -> torch.Tensor:
    """A shard's global source rows → its local rows, ``(r // beam) * beam +
    rem(idx, beam)``, as JAX's shard computes them (``lax.rem`` truncates,
    as ``torch.fmod`` does). Beam selection never crosses samples, and the
    shard holds whole samples, so the result indexes the shard's rows."""
    r = torch.arange(idx_block.shape[0], device=idx_block.device)
    return (r // beam) * beam + torch.fmod(idx_block.long(), beam)


def permute_append_sharded_reference(
    cache_k: torch.Tensor, cache_v: torch.Tensor, idx_block: torch.Tensor,
    layer: int, pos: int, parity: int, k_new: torch.Tensor, v_new: torch.Tensor,
    *, beam: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2′: :func:`localize`, then K2's plain version."""
    _check_beam(cache_k, beam)
    return permute_append_reference(
        cache_k, cache_v, localize(idx_block, beam), layer, pos, parity, k_new, v_new
    )


def permute_append(
    cache_k: torch.Tensor,  # [2, L, BK, ctx, HD] storage dtype
    cache_v: torch.Tensor,
    idx: torch.Tensor,  # [BK] int32 destination → source rows (duplicates allowed)
    layer: int,
    pos,  # the new rows land at this position: an int, or one int64 on the planes' device
    parity: int,  # read plane; the write plane is 1 - parity
    k_new: torch.Tensor,  # [BK, HD] new rows, any strides; on CUDA a pair of CAST_PAIRS
    v_new: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the pending beam permutation and append, in place. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one launch
    covers K and V and the new rows' cast). Returns (cache_k, cache_v)."""
    global launches
    if cache_k.device.type == "cpu":
        return permute_append_reference(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    _launch(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new, beam=0)
    launches += 1
    return cache_k, cache_v


def permute_append_sharded(
    cache_k: torch.Tensor,  # [2, L, BK/d, ctx, HD] this rank's rows, storage dtype
    cache_v: torch.Tensor,
    idx_block: torch.Tensor,  # [BK/d] int32 GLOBAL source rows of this rank's rows
    layer: int,
    pos: int,
    parity: int,
    k_new: torch.Tensor,  # [BK/d, HD]
    v_new: torch.Tensor,
    *,
    beam: int,  # rows per sample; the shard holds whole samples
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on one rank of a data-parallel mesh, in place: the counterpart of
    the per-shard body of JAX's ``permute_append_sharded``. The kernel makes
    each global source row local itself (an index whose local row falls
    outside the shard traps). CPU tensors take the plain version; CUDA
    tensors launch the kernel. ``pos`` is an int. Returns (cache_k,
    cache_v)."""
    global sharded_launches
    if isinstance(pos, torch.Tensor):
        raise TypeError(f"{SHARDED_KERNEL}: pos must be an int")
    if cache_k.device.type == "cpu":
        return permute_append_sharded_reference(
            cache_k, cache_v, idx_block, layer, pos, parity, k_new, v_new, beam=beam
        )
    _check_beam(cache_k, beam)
    _launch(cache_k, cache_v, idx_block, layer, pos, parity, k_new, v_new, beam=beam)
    sharded_launches += 1
    return cache_k, cache_v


def _kernel_args(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new) -> tuple:
    """Check the operands of a CUDA launch and return the C entry's
    arguments up to ``parity``; raises where the kernel does not take them.
    The new rows go as they are: pointer, row stride in bytes, element
    stride, dtype code. A device ``pos`` goes as -1 (its pointer is the
    entry's last argument)."""
    _check(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    _, n_layer, bk, ctx, hd = cache_k.shape
    isz = cache_k.element_size()
    if not supported(hd, isz):
        raise ValueError(f"{KERNEL}: a position of {hd * isz} bytes is not a multiple of {_VEC}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(f"{KERNEL}: on CUDA idx must be contiguous int32, got {idx.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if not t.is_contiguous() or t.data_ptr() % _VEC:
            raise ValueError(f"{KERNEL}: {name} must be contiguous and 16-byte aligned")
    if v_new.dtype != k_new.dtype or (k_new.dtype, cache_k.dtype) not in CAST_PAIRS:
        raise TypeError(
            f"{KERNEL}: no conversion of {k_new.dtype} / {v_new.dtype} rows into "
            f"{cache_k.dtype} planes on CUDA"
        )
    rsz = k_new.element_size()
    return (
        cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_new.stride(0) * rsz, k_new.stride(1), v_new.stride(0) * rsz, v_new.stride(1),
        DTYPE_CODES[k_new.dtype], DTYPE_CODES[cache_k.dtype], int(e4m3_saturates()),
        idx.data_ptr(), n_layer, bk, ctx, hd, isz, int(layer),
        -1 if isinstance(pos, torch.Tensor) else int(pos), int(parity),
    )


@functools.lru_cache(maxsize=None)
def e4m3_saturates() -> bool:
    """The installed PyTorch's rule for ``float8_e4m3fn`` overflow, which
    the kernel follows to store ``.to()``'s bytes: True where inf and
    values past ±448 go to ±448 (later releases), False where they go to
    NaN (up to 2.11). Read from one cast of 480 on the CPU, which runs the
    same c10 conversion as the CUDA cast."""
    return torch.tensor([480.0]).to(torch.float8_e4m3fn).view(torch.uint8).item() == 0x7E


def _launch(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new, *, beam: int) -> None:
    """Launch K2 (``beam == 0``) or K2′ on CUDA operands; raises where the
    kernel does not take them."""
    if cache_k.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {cache_k.device}")
    args = _kernel_args(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
    rc = _library().permute_append(
        *args, int(beam), cache_k.device.index or 0,
        torch.cuda.current_stream(cache_k.device).cuda_stream,
        pos.data_ptr() if isinstance(pos, torch.Tensor) else None,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with its entry's argument types, bound once."""
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    lib.permute_append.argtypes = (
        [ctypes.c_void_p] * 4  # planes K, V; new rows K, V
        + [ctypes.c_int64] * 4  # row and element strides of the new rows
        + [ctypes.c_int] * 3  # row dtype, storage dtype, e4m3_saturates
        + [ctypes.c_void_p]  # idx
        + [ctypes.c_int] * 10  # n_layer, bk, ctx, hd, itemsize, layer, pos, parity, beam, device
        + [ctypes.c_void_p] * 2  # stream; the device pos or NULL
    )
    lib.permute_append.restype = ctypes.c_int
    return lib
