"""Pending beam permutation plus append on ping-pong KV planes (K2), and
the same on one data shard of a mesh (K2′).

Counterpart of ``permute_append`` and ``permute_append_sharded`` in
``whisper_tpu/ops/fused_step.py``, the kernels of the beam step mode
``"hybrid"`` (``models/decoder.py`` ``decoder_step_fused``). The cache is a
plane pair ``[2, L, BK, ctx, HD]`` (HD = H·Dh) in its storage dtype; one
call, for one layer, makes the write plane ``1 - parity`` the read plane
``parity`` gathered by ``idx`` (the beam permutation chosen at the
previous step) with this step's new K/V rows at ``pos``. K2′ is K2 on a
rank of a data-parallel mesh: the planes hold the rank's rows, ``idx`` their
global source rows, made local in the kernel. A CUDA tensor runs the
hand-written kernels of ``csrc/permute_append.cu``; a CPU tensor runs
:func:`permute_append_reference` or :func:`permute_append_sharded_reference`,
the plain versions. There is no fallback: a CUDA tensor the kernel does not
take raises.

Only the window ``[0, pos]`` of the write plane is written: the positions
past ``pos`` are unspecified, as in the JAX contract, and the decoder reads
``[0, pos]`` only. The JAX kernel copies whole rows. The planes are updated
in place and returned.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

KERNEL = "permute_append"  # the library both kernels live in (csrc/permute_append.cu)
KERNEL_SYMBOL = "permute_append_kernel"  # in the names of its device functions (profiler traces)
SHARDED_KERNEL = "permute_append_sharded"
SHARDED_KERNEL_SYMBOL = "permute_append_sharded_kernel"
_VEC = 16  # bytes per vector load and store in the kernel

# Launches of each CUDA kernel in this process (plain versions not counted).
launches = 0  # K2
sharded_launches = 0  # K2′


def supported(hd: int, itemsize: int) -> bool:
    """Whether the CUDA kernel takes a merged head dim ``hd`` stored in
    ``itemsize``-byte elements: a cache position must be whole 16-byte
    vectors."""
    return hd * itemsize % _VEC == 0


def _check(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new) -> None:
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
    if not (0 <= layer < n_layer and 0 <= pos < ctx and parity in (0, 1)):
        raise ValueError(f"{KERNEL}: layer {layer}, pos {pos}, parity {parity} out of range")
    devices = {t.device for t in (cache_k, cache_v, idx, k_new, v_new)}
    if len(devices) != 1:
        raise ValueError(f"{KERNEL}: operands on several devices: {devices}")


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
    rows (cast to the storage dtype) at ``pos``."""
    _check(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new)
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
    pos: int,  # the new rows land at this position
    parity: int,  # read plane; the write plane is 1 - parity
    k_new: torch.Tensor,  # [BK, HD] new rows, any float dtype
    v_new: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the pending beam permutation and append, in place. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one launch
    covers K and V). Returns (cache_k, cache_v)."""
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
    tensors launch the kernel. Returns (cache_k, cache_v)."""
    global sharded_launches
    if cache_k.device.type == "cpu":
        return permute_append_sharded_reference(
            cache_k, cache_v, idx_block, layer, pos, parity, k_new, v_new, beam=beam
        )
    _check_beam(cache_k, beam)
    _launch(cache_k, cache_v, idx_block, layer, pos, parity, k_new, v_new, beam=beam)
    sharded_launches += 1
    return cache_k, cache_v


def _launch(cache_k, cache_v, idx, layer, pos, parity, k_new, v_new, *, beam: int) -> None:
    """Check the operands of a CUDA launch and launch K2 (``beam == 0``) or
    K2′; raises where the kernel does not take them."""
    if cache_k.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {cache_k.device}")
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
    # The kernel moves bytes only: the new rows go to the storage dtype here.
    kn = k_new.to(cache_k.dtype).contiguous()
    vn = v_new.to(cache_v.dtype).contiguous()
    for name, t in (("k_new", kn), ("v_new", vn)):
        if t.data_ptr() % _VEC:  # a view at an unaligned offset, passed through as is
            raise ValueError(f"{KERNEL}: {name} in the storage dtype must be 16-byte aligned")
    lib = _library()
    args = (
        cache_k.data_ptr(), cache_v.data_ptr(), kn.data_ptr(), vn.data_ptr(), idx.data_ptr(),
        n_layer, bk, ctx, hd * isz // _VEC, int(layer), int(pos), int(parity),
    )
    where = (cache_k.device.index or 0, torch.cuda.current_stream(cache_k.device).cuda_stream)
    if beam:
        rc = lib.permute_append_sharded(*args, int(beam), *where)
    else:
        rc = lib.permute_append(*args, *where)
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")


def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    common = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    where = [ctypes.c_int, ctypes.c_void_p]  # device, stream
    lib.permute_append.argtypes = common + where
    lib.permute_append_sharded.argtypes = common + [ctypes.c_int] + where  # beam
    lib.permute_append.restype = lib.permute_append_sharded.restype = ctypes.c_int
    return lib
