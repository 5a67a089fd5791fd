"""The routed experts of a mixture-of-experts layer, in one call per layer.

Replaces no TPU kernel: the JAX package runs no mixture of experts. It was
added for the audio language models of ``config.AUDIO_LM_DIMS``
(``models/audio_lm.py``), whose layers route each token to 0, 1 or 2 of
their SwiGLU experts, a choice known only on the device.

:func:`moe_experts` computes, for every token ``t`` and each of its slots
``j`` that names a routed expert ``e = expert[t, j]``,

    y[t] += weight[t, j] · (silu(x[t] W_gate[e]) ⊙ (x[t] W_up[e])) W_down[e]

and returns ``y`` in float32 with the per-expert counts of rows. A CPU
tensor takes :func:`moe_experts_reference`, the plain version; a CUDA
tensor launches the two kernels of ``csrc/moe_expert.cu``
(``moe_expert_gate_up_*``, ``moe_expert_down_*``), with no fallback.

How the card's path is laid out. :func:`plan` sorts the (token, slot)
pairs by expert on the device with fixed shapes (a one-hot running count,
no sort and no host read): ``order`` lists the pair ids expert by expert,
then the pairs routed nowhere; ``counts`` gives each expert's rows. Each
kernel's grid is ``(cdiv(P, BM) + E) · column tiles`` for P pairs, a
function of the batch's shape only, so the call can be captured in a CUDA
graph; a block finds its expert and its rows from ``counts`` and exits at
once where they are empty, so an expert with no row has none of its
weights read. The first kernel writes the SwiGLU activations of the
sorted pairs, rounded to the weights' type, as the plain version rounds
them; the second multiplies them by ``W_down``, scales by the gate's
weight and adds each row into ``y`` with float32 atomics. A token has at
most two routed slots, so each element of ``y`` receives at most two adds
onto zero, and ``0 + a + b == 0 + b + a``: the result does not depend on
their order.

Bound on the card: bytes in a decode step (each routed expert's three
matrices read once, 407 MB each at the published widths, against a few
dozen rows), operations in a prefill (6 · d · f FLOPs per routed row).
:data:`VARIANTS` picks the kernels' tile shapes (the table in the
``.cu`` file) for a decode (up to :data:`SMALL` pairs) and a prefill, and
:data:`GROUPS` how many column tiles of one row block run side by side.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

KERNEL = "moe_expert"
KERNEL_SYMBOL = "moe_expert"  # the prefix of both kernels' names in a profiler trace
SMALL = 512  # pairs up to which the decode's variants apply
# Indices into the .cu file's variant table, (gate/up, down), by
# ``pairs <= SMALL``; and the column tiles rasterised together (0: all).
VARIANTS = {True: (0, 2), False: (1, 3)}
GROUPS = {True: (1, 1), False: (8, 0)}
_ALIGN = 16  # bytes: the kernels copy 16-byte chunks

# Launches of the card's kernels in this process (two a call; the plain
# version counts nothing; a replayed graph adds what its capture launched).
launches = 0


def plan(expert: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expert`` [N, K] (``n_experts`` where a slot routes nowhere) → the
    pair ids ``t·K + j`` sorted by expert, stable, with the unrouted pairs
    last (int32 [N·K]), and each expert's count of pairs (int32 [E])."""
    key = expert.reshape(-1)
    onehot = (key[:, None] == torch.arange(n_experts + 1, device=key.device)).to(torch.int32)
    running = onehot.cumsum(0, dtype=torch.int32)
    counts = running[-1]
    rank = running.gather(1, key[:, None])[:, 0] - 1
    dest = (counts.cumsum(0, dtype=torch.int32) - counts)[key] + rank
    ids = torch.arange(key.numel(), dtype=torch.int32, device=key.device)
    order = torch.empty_like(ids).scatter_(0, dest.long(), ids)
    return order, counts[:n_experts]


def moe_experts_reference(x, expert, weight, w_gate, w_up, w_down):
    """Plain version of :func:`moe_experts`: each expert over its rows, the
    products in float32, the activations rounded to ``x``'s type."""
    n, k = expert.shape
    e_count = w_gate.shape[0]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    counts = torch.zeros(e_count, dtype=torch.int32, device=x.device)
    for e in range(e_count):
        pairs = (expert.reshape(-1) == e).nonzero()[:, 0]
        counts[e] = pairs.numel()
        if not pairs.numel():
            continue
        tok = pairs // k
        xe = x[tok].float()
        h = (F.silu(xe @ w_gate[e].float()) * (xe @ w_up[e].float())).to(x.dtype)
        out = (h.float() @ w_down[e].float()) * weight.reshape(-1)[pairs].float()[:, None]
        y.index_add_(0, tok, out)
    return y, counts


def _check(x, expert, weight, w_gate, w_up, w_down) -> None:
    n, d = x.shape
    e, d2, f = w_gate.shape
    if (d2 != d or tuple(w_up.shape) != (e, d, f) or tuple(w_down.shape) != (e, f, d)
            or expert.shape != weight.shape or expert.shape[0] != n):
        raise ValueError(
            f"{KERNEL}: x {tuple(x.shape)}, expert {tuple(expert.shape)}, weight "
            f"{tuple(weight.shape)}, W_gate {tuple(w_gate.shape)}, W_up {tuple(w_up.shape)}, "
            f"W_down {tuple(w_down.shape)} do not fit [N, D], [N, K], [E, D, F], [E, F, D]"
        )
    if expert.shape[1] > 2:
        raise ValueError(f"{KERNEL}: at most 2 slots a token, got {expert.shape[1]}")


def moe_experts(x, expert, weight, w_gate, w_up, w_down):
    """``x`` [N, D], ``expert`` [N, K] int64 (``E`` where a slot routes to
    no routed expert), ``weight`` [N, K] float32, ``w_gate`` and ``w_up``
    [E, D, F], ``w_down`` [E, F, D] → (y [N, D] float32, counts [E] int32).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    global launches
    _check(x, expert, weight, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_experts_reference(x, expert, weight, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {x.device}")
    for name, t in (("x", x), ("W_gate", w_gate), ("W_up", w_up), ("W_down", w_down)):
        if not t.is_contiguous() or t.dtype != torch.bfloat16 or t.data_ptr() % _ALIGN:
            raise ValueError(f"{KERNEL}: {name} must be contiguous bfloat16, "
                             f"{_ALIGN}-byte aligned")
    n, d = x.shape
    e, _, f = w_gate.shape
    top_k = expert.shape[1]
    small = n * top_k <= SMALL
    vg, vd = VARIANTS[small]
    (_, _, bn_g, bk_g), (_, _, bn_d, bk_d) = variant(vg)[:4], variant(vd)[:4]
    if d % bk_g or f % bn_g or f % bk_d or d % bn_d:
        raise ValueError(f"{KERNEL}: d {d} and f {f} must be multiples of the tiles "
                         f"(gate/up BK {bk_g}, BN {bn_g}; down BK {bk_d}, BN {bn_d})")
    order, counts = plan(expert, e)
    weight = weight.reshape(-1).float().contiguous()
    p = order.numel()
    h = torch.empty((p, f), dtype=x.dtype, device=x.device)
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    gg, gd = GROUPS[small]
    rc = _library().moe_expert(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
        y.data_ptr(), order.data_ptr(), counts.data_ptr(), weight.data_ptr(), p, d, f, e, top_k,
        vg, vd, gg, gd, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed with cudaError {rc}")
    launches += 2
    return y, counts


@functools.lru_cache(maxsize=None)
def variant(v: int) -> Tuple[int, ...]:
    """Variant ``v`` of the kernel table: (gated, BM, BN, BK, threads,
    shared bytes)."""
    out = (ctypes.c_int * 6)()
    if _library().moe_expert_variant(v, out) != 0:
        raise ValueError(f"{KERNEL}: no variant {v}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from whisper_tpu_torch.ops.build import load_library

    lib = load_library(KERNEL)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_expert.argtypes = [ptr] * 9 + [i] * 9 + [ptr]
    lib.moe_expert.restype = i
    lib.moe_expert_variant.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.moe_expert_variant.restype = i
    return lib
