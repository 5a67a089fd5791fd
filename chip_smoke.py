#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisper_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. Card: name and power limit (nvidia-smi), compute capability (must be 9.0).
2. Build: every kernel of the main path, with nvcc from the sources in
   ``whisper_tpu_torch/csrc/`` (into ``build/whisper_tpu_torch/``).
3. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and a few others, with the tolerance stated (K1: 4 bf16
   ulps, at T = 1, 100, 256, 512, 1024, 1499 and 1500, Dh = 32 and 64,
   ``unbind`` views, and f32 at 1e-5; K2 and K4 move bytes: bitwise; K3: planes bitwise, attention 4 bf16
   ulps or 1e-5 in f32, and JAX's tolerances against
   ``reference_gather_attend``; K5: 2e-4 in log-mel units, also against
   ``frontend/mel.py``); times of the kernel, the plain version and the
   library call (or the nearest composite, labelled) beside the bound;
   K1 and ``scaled_dot_product_attention`` also at T = 256, 512, 1024 and
   1500 at large-v3 width (batch 4, 20 heads), one line per T.
   K5's path is its entry point on the main path's batch: one launch. K2′
   (K2 on one rank of a data-parallel mesh) bitwise on rank 1's planes of
   a batch of 4 on 2 ranks, with global source rows.
4. Greedy main path at full width: ``create_engine(MONOLITH, EngineConfig(
   model="large-v3", max_new_tokens=64), device="cuda")`` with random
   weights from a seed; ``transcribe_batch`` of 4 utterances of different
   lengths and ``transcribe`` of a WAV file. Launch counts are set to 0
   just before and read just after: K1 must run once per encoder layer of
   every encode, K2, K3, K4 and K5 never. Prints audio-s/s, encoder ms and
   decode ms/token.
4b. Beam main path at full width: the same with ``beam_size=5,
   quantization="int8", kv_cache_dtype="float8_e4m3fn"`` and
   ``fused_step`` left at "auto" (K2's "hybrid" on the card): K2 must run
   once per decoder layer of every decode step, K3, K4 and K5 never. Then
   ``fused_step="off"`` on the same weights: K4 twice per step (K and V),
   K2 never, and tokens equal to the hybrid run's (the two modes run the
   same arithmetic on the same bytes).
4c. K3's path at full width: ``utils/probe_fused.run`` at large-v3, batch
   4, beam 5, ctx 68, fp8 planes, in its modes "attend" (K3 32 × steps, K2
   never), "dma" and "hybrid" (K2 32 × steps, K3 never), ms per 32-layer
   step each; then one step of "attend" against one of "hybrid": gathered
   windows bitwise, ``h`` within ``probe_fused.compare_runs``' tolerance.
4d. The data-parallel path at full width: phase 4b's config with
   ``mesh_shape=(2, 1)``: two ranks, two processes of
   ``parallel/_dist_worker`` on this one card in a gloo world, each
   ``transcribe_batch`` of the same 4 utterances and decoding its 2. Each
   rank must hold phase 4b's weights (checksum), launch K2′ once per
   decoder layer of every step, K1 once per encoder layer, K2 and K4
   never, and return the same 4 results as the other; each rank's rows
   must equal a run of the same 2 rows in this process, with the crop the
   ranks used. Agreement with phase 4b's batch-4 tokens is printed only.
5. Kernel path against the CPU path end to end: ``tiny`` dims in float32,
   TF32 off for matmuls and cuDNN, the same weights on the card and on the
   CPU must give equal tokens for a batch of 2: greedy; beam 3 with the
   card's "hybrid", the card's "off" and the CPU's "off"; beam 3 with int8
   weights and the fp8 KV cache, card "hybrid" against CPU "off"; and beam
   3 on two ranks on the card (``mesh_shape=(2, 1)``) under "hybrid" (K2′)
   and "off" against CPU "off".

Then, each on a line of its own: the kernels' JSON record, the card's name
and power limit, and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
LARGE_V3_ENC_LAYERS = 32
LARGE_V3_DEC_LAYERS = 32
FP8 = "float8_e4m3fn"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, inner: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``inner`` calls queued back to back
    between two CUDA events, behind a spin kernel that keeps the card busy
    while the host enqueues them, so that host time (argument checks, ctypes,
    allocation) is not counted. If the spin ended before the host finished
    enqueueing, the window is taken again with a spin twice as long. Median
    over ``reps`` windows, divided by ``inner``."""
    import torch

    fn()  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    spin_cycles = 20_000_000  # about 10 ms at the H100's clock
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        starved = start.query()  # spin already over: the card may have waited
        end.synchronize()
        if starved:
            if spin_cycles >= 2**32:
                fail("host cannot enqueue the timed calls ahead of the card")
            spin_cycles *= 2
            continue
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms_per_call(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn`` (enqueue only): ``calls`` calls made
    while a spin kernel keeps the card busy, on the host clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # about 20 ms: the calls queue behind it
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def attention_bound_ms(b, t, h, dh, itemsize) -> tuple:
    """Least time for non-causal attention on [B, T, H, Dh]: the larger of
    4·B·H·T²·Dh operations over the peak rate for the dtype and the bytes of
    q, k, v read once and o written once over the memory rate."""
    flops = 4.0 * b * h * t * t * dh
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    by_ops = flops / peak * 1e3
    by_bytes = 4.0 * b * t * h * dh * itemsize / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def bf16_tolerance(ref_max: float) -> float:
    """4 bf16 ulps at the output's largest magnitude: kernel and plain
    version each round the softmax weights (2^-9 relative) and the output
    to bf16, at different places (unnormalised vs normalised weights)."""
    return 4.0 * 2.0 ** (np.floor(np.log2(max(ref_max, 2.0**-20))) - 7)


def phase_kernels(torch, attention) -> dict:
    """K1 against its plain version at the main path's shape (the record,
    also timed beside the plain version and ``scaled_dot_product_attention``),
    at the encoder's ``audio_ctx`` buckets and ragged lengths (T = 1, 100,
    256, 512, 1024, 1499 at 20 heads), at Dh = 32, on ``unbind`` views of
    one [B, T, 3, H, Dh] projection, and in f32. Then one line per T ∈
    {256, 512, 1024, 1500} at large-v3 width (batch 4, 20 heads): K1,
    ``scaled_dot_product_attention`` and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("large-v3 encoder", (4, 1500, 20, 64), torch.bfloat16),
        ("tiny encoder", (4, 1500, 6, 64), torch.bfloat16),
        # The mask check: 28 of the last K/V tile's 128 keys lie past T (one
        # ragged tile). At T=1500, 36 of 1536 keys are masked, too few for
        # the tolerance to catch a kernel that gives them weight.
        ("ragged T=100", (4, 100, 20, 64), torch.bfloat16),
        ("one key T=1", (4, 1, 20, 64), torch.bfloat16),
        ("bucket T=256 (no mask)", (4, 256, 20, 64), torch.bfloat16),
        ("bucket T=512 (no mask)", (4, 512, 20, 64), torch.bfloat16),
        ("bucket T=1024 (no mask)", (4, 1024, 20, 64), torch.bfloat16),
        ("ragged T=1499", (4, 1499, 20, 64), torch.bfloat16),
        ("dev encoder, Dh=32", (4, 1500, 2, 32), torch.bfloat16),
        ("Dh=32, T=64", (4, 64, 4, 32), torch.bfloat16),
        ("unbind views", (2, 300, 4, 64), "strided"),
        ("unbind views, Dh=32", (2, 300, 4, 32), "strided"),
        ("tiny encoder f32", (2, 1500, 6, 64), torch.float32),
        ("f32 Dh=32, T=300", (2, 300, 2, 32), torch.float32),
    ]
    record = None
    for name, shape, dtype in cases:
        if dtype == "strided":  # q, k, v as views of one fused projection
            b, t, h, dh = shape
            dtype = torch.bfloat16
            x = torch.randn((b, t, 3, h, dh), generator=gen, device="cuda").to(dtype)
            q, k, v = x.unbind(2)
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        before = attention.launches
        out = attention.fused_self_attention(q, k, v)
        torch.cuda.synchronize()
        if attention.launches != before + 1:
            fail(f"K1 wrapper did not launch its kernel once at {name}")
        ref = attention.fused_self_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_tolerance(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        ok = bool(torch.isfinite(out).all()) and err <= tol
        kern_ms = time_ms(lambda: attention.fused_self_attention(q, k, v))
        bound, bound_by = attention_bound_ms(*shape, q.element_size())
        log(
            f"  K1 {name} {list(shape)} {str(dtype)[6:]}: max_abs_err {err:.3g} "
            f"(max|ref| {ref_max:.3g}, rel {err / ref_max:.3g}, tol {tol:.3g}) "
            f"kernel {kern_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})"
        )
        if not ok:
            fail(f"K1 disagrees with its plain version at {name}: {err} > {tol}")
        if record is None:  # the main path's shape: also time plain and library
            plain_ms = time_ms(lambda: attention.fused_self_attention_reference(q, k, v))
            lib_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                )
            )
            host_ms = host_ms_per_call(lambda: attention.fused_self_attention(q, k, v))
            log(f"    plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms; "
                f"the wrapper's host time per call (checks, three tensor-map encodes, ctypes, "
                f"allocation) {host_ms:.4f} ms")
            record = {
                "name": "flash_attn_fwd", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": "whisper_tpu/ops/attention.py:33",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms, "shape": list(shape), "dtype": "bfloat16",
                "host_ms": host_ms,
            }
    per_t = []
    for t in (256, 512, 1024, 1500):
        shape = (4, t, 20, 64)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        kern_ms = time_ms(lambda: attention.fused_self_attention(q, k, v))
        lib_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        )
        bound, bound_by = attention_bound_ms(*shape, 2)
        tflops = 4.0 * 4 * 20 * t * t * 64 / kern_ms / 1e9
        log(f"  K1 at T={t} {list(shape)} bf16: kernel {kern_ms:.4f} ms ({tflops:.0f} TFLOP/s), "
            f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
            f"kernel / library {kern_ms / lib_ms:.3f}")
        per_t.append({"t": t, "ms": kern_ms, "library_ms": lib_ms, "bound_ms": bound})
    record["per_t"] = per_t
    return record


def _as_bytes(t):
    import torch

    return t.contiguous().view(torch.uint8)


def bytes_bound_ms(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES * 1e3


def mel_bound(b: int, n_mels: int, filt_nnz: int) -> dict:
    """Least time for the log-mel of ``b`` windows of 480000 samples (K5's
    function, before the epilogue): the larger of the bytes (samples read
    once, [b, n_mels, 3000] written once) over the memory rate and the
    operations the function needs per frame over the f32 rate: the window
    (400), a real FFT of 400 points (2.5·N·log2 N, half a complex FFT's
    5·N·log2 N), the power (3 per bin), the filterbank's non-zeros (2 each)
    and the log (1 per mel). ``dense_*`` is the same for the dense DFT the
    kernel computes (2·400·402 + 2·201·n_mels per frame): the rate of its
    algorithm, not a bound on the function."""
    frames = b * 3000
    n = 400
    flops = frames * (n + 2.5 * n * np.log2(n) + 3 * 201 + 2 * filt_nnz + n_mels)
    dense = frames * (2 * n * 402 + 2 * 201 * n_mels)
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    by_bytes = bytes_bound_ms(b * (480_000 + n_mels * 3000) * 4)
    bound, by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return {"ms": bound, "by": by, "gflop": float(flops) / 1e9, "dense_gflop": dense / 1e9,
            "dense_ms": max(dense / PEAK_F32_FLOPS * 1e3, by_bytes)}


def phase_permute_append(torch, fused_step) -> dict:
    """K2 against its plain version, bitwise, at the beam main path's shape
    (large-v3 beam 5 batch 4: planes [2, 32, 20, 68, 1280], in fp8 and
    bf16, at pos 4, 35 and 67, both parities) and at a tiny f32 and a dev
    fp8 shape. The record is the fp8 case at pos 35 (about the mean
    position of a 64-token decode after a 4-token prompt)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    dtypes = {"fp8": getattr(torch, FP8), "bf16": torch.bfloat16, "f32": torch.float32}
    cases = [((2, 32, 20, 68, 1280), d, pos) for d in ("fp8", "bf16") for pos in (4, 35, 67)]
    cases += [((2, 4, 6, 40, 384), "f32", 17), ((2, 2, 6, 17, 64), "fp8", 9)]
    record = None
    for shape, dname, pos in cases:
        _, n_layer, bk, ctx, hd = shape
        dt = dtypes[dname]
        idx = torch.randint(0, bk, (bk,), generator=gen, device="cuda", dtype=torch.int32)
        idx[1] = idx[0]  # beam branching: a duplicate, always
        layer = n_layer // 2
        planes = [
            (4 * torch.randn(shape, generator=gen, device="cuda")).to(dt) for _ in range(2)
        ]
        new = [torch.randn((bk, hd), generator=gen, device="cuda") for _ in range(2)]
        err = 0.0
        for parity in (0, 1):
            ck, cv = (p.clone() for p in planes)
            rk, rv = (p.clone() for p in planes)
            fused_step.permute_append(ck, cv, idx, layer, pos, parity, *new)
            fused_step.permute_append_reference(rk, rv, idx, layer, pos, parity, *new)
            torch.cuda.synchronize()
            w = 1 - parity
            # The written window [0, pos] of the write plane, and everything
            # the call must leave alone: the read plane and the write
            # plane's other layers. Past pos the write plane is unspecified.
            for a, b in ((ck, rk), (cv, rv)):
                win_a, win_b = a[w, layer, :, : pos + 1], b[w, layer, :, : pos + 1]
                same = all(
                    torch.equal(_as_bytes(x), _as_bytes(y))
                    for x, y in ((win_a, win_b), (a[parity], b[parity]),
                                 (a[w, :layer], b[w, :layer]), (a[w, layer + 1:], b[w, layer + 1:]))
                )
                if not same:
                    fail(f"K2 differs from its plain version at {list(shape)} {dname} pos {pos} parity {parity}")
                err = max(err, (win_a.float() - win_b.float()).abs().max().item())
        # Bytes this run's data needs moved: each distinct source row of the
        # window [0, pos) read once (a repeated row is served from L2), the
        # new rows read, the window [0, pos] of every row written; K and V.
        # The kernel is timed on new rows already in the storage dtype; the
        # wrapper's casts of f32 rows (two more launches) are timed beside it.
        isz = planes[0].element_size()
        n_src = int(torch.unique(idx).numel())
        bound = bytes_bound_ms(2 * hd * isz * (n_src * pos + bk + bk * (pos + 1)))
        stored = [n.to(dt) for n in new]
        kern_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *stored))
        cast_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *new))
        log(
            f"  K2 {list(shape)} {dname} pos {pos}: bitwise equal (both parities); "
            f"kernel {kern_ms:.4f} ms (with the f32 rows' casts {cast_ms:.4f}), "
            f"bound {bound:.4f} ms (bytes; {n_src} distinct of {bk} source rows)"
        )
        if record is None and pos == 35:
            plain_ms = time_ms(
                lambda: fused_step.permute_append_reference(ck, cv, idx, layer, pos, 0, *stored)
            )
            idx_l = idx.long()
            srcs = [_as_bytes(p)[0, layer, :, :pos] for p in (ck, cv)]
            dsts = [torch.empty_like(s, memory_format=torch.contiguous_format) for s in srcs]

            def library():
                for s_, d_ in zip(srcs, dsts):
                    torch.index_select(s_, 0, idx_l, out=d_)

            lib_ms = time_ms(library)
            # The same call on a permutation without duplicates: every
            # source row read from memory.
            perm = torch.randperm(bk, generator=gen, device="cuda").to(torch.int32)
            perm_ms = time_ms(lambda: fused_step.permute_append(ck, cv, perm, layer, pos, 0, *stored))
            perm_bound = bytes_bound_ms(2 * hd * isz * (bk * pos + bk + bk * (pos + 1)))
            log(
                f"    plain {plain_ms:.4f} ms, index_select of the window (gather only, no append) "
                f"{lib_ms:.4f} ms; on a permutation without duplicates: kernel {perm_ms:.4f} ms, "
                f"bound {perm_bound:.4f} ms"
            )
            record = {
                "name": "permute_append", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/permute_append.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:628",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms, "shape": list(shape), "dtype": FP8, "pos": pos,
                "distinct_sources": n_src, "permutation_ms": perm_ms,
                "permutation_bound_ms": perm_bound,
            }
    return record


def phase_permute_append_sharded(torch, fused_step) -> dict:
    """K2′ against its plain version, bitwise, on one rank's planes of the
    data-parallel beam path (large-v3 beam 5, a batch of 4 on 2 ranks:
    planes [2, 32, 10, 68, 1280]) with rank 1's global source rows (10..19,
    each within its sample, a duplicate always), fp8 at pos 35 (the record)
    and bf16 at pos 67, both parities, plus a tiny f32 shape. K2's count
    must not move. Timed beside its bound, the plain version and
    ``index_select`` of the localised K and V windows."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [((2, 32, 10, 68, 1280), getattr(torch, FP8), 5, 35),
             ((2, 32, 10, 68, 1280), torch.bfloat16, 5, 67),
             ((2, 4, 6, 40, 384), torch.float32, 3, 17)]
    record = None
    for shape, dt, beam, pos in cases:
        _, n_layer, bk, ctx, hd = shape
        src = torch.randint(0, beam, (bk,), generator=gen, device="cuda")
        src[1] = src[0]
        idx = (bk + (torch.arange(bk, device="cuda") // beam) * beam + src).to(torch.int32)
        layer = n_layer // 2
        planes = [(4 * torch.randn(shape, generator=gen, device="cuda")).to(dt) for _ in range(2)]
        new = [torch.randn((bk, hd), generator=gen, device="cuda") for _ in range(2)]
        err = 0.0
        k2_before = fused_step.launches
        for parity in (0, 1):
            ck, cv = (p.clone() for p in planes)
            rk, rv = (p.clone() for p in planes)
            fused_step.permute_append_sharded(ck, cv, idx, layer, pos, parity, *new, beam=beam)
            fused_step.permute_append_sharded_reference(rk, rv, idx, layer, pos, parity, *new, beam=beam)
            torch.cuda.synchronize()
            w = 1 - parity
            for a, b in ((ck, rk), (cv, rv)):
                win_a, win_b = a[w, layer, :, : pos + 1], b[w, layer, :, : pos + 1]
                same = all(
                    torch.equal(_as_bytes(x), _as_bytes(y))
                    for x, y in ((win_a, win_b), (a[parity], b[parity]),
                                 (a[w, :layer], b[w, :layer]), (a[w, layer + 1:], b[w, layer + 1:]))
                )
                if not same:
                    fail(f"K2′ differs from its plain version at {list(shape)} {dt} pos {pos} parity {parity}")
                err = max(err, (win_a.float() - win_b.float()).abs().max().item())
        if fused_step.launches != k2_before:
            fail("K2′ launched K2")
        # Bytes this run's data needs moved, as K2's record counts them.
        local = fused_step.localize(idx, beam)
        isz = planes[0].element_size()
        n_src = int(torch.unique(local).numel())
        bound = bytes_bound_ms(2 * hd * isz * (n_src * pos + bk + bk * (pos + 1)))
        stored = [n.to(dt) for n in new]
        kern_ms = time_ms(lambda: fused_step.permute_append_sharded(
            ck, cv, idx, layer, pos, 0, *stored, beam=beam))
        log(
            f"  K2′ {list(shape)} {str(dt)[6:]} pos {pos}, global rows {bk}..{2 * bk - 1}: bitwise "
            f"equal (both parities); kernel {kern_ms:.4f} ms, bound {bound:.4f} ms "
            f"(bytes; {n_src} distinct of {bk} source rows)"
        )
        if record is None:
            plain_ms = time_ms(lambda: fused_step.permute_append_sharded_reference(
                ck, cv, idx, layer, pos, 0, *stored, beam=beam))
            srcs = [_as_bytes(p)[0, layer, :, :pos] for p in (ck, cv)]
            dsts = [torch.empty_like(s, memory_format=torch.contiguous_format) for s in srcs]

            def library():  # index_select of the localised windows: the gather only
                for s_, d_ in zip(srcs, dsts):
                    torch.index_select(s_, 0, local, out=d_)

            lib_ms = time_ms(library)
            local32 = local.int()
            k2_ms = time_ms(lambda: fused_step.permute_append(ck, cv, local32, layer, pos, 0, *stored))
            log(f"    plain {plain_ms:.4f} ms, index_select of the localised windows (gather only, "
                f"no append) {lib_ms:.4f} ms; K2 on the same rows numbered locally {k2_ms:.4f} ms")
            record = {
                "name": "permute_append_sharded", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/permute_append.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:737",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms, "library_call": "index_select x2 of the localised windows",
                "shape": list(shape), "dtype": FP8, "pos": pos, "global_rows": [bk, 2 * bk - 1],
                "distinct_sources": n_src, "k2_local_ms": k2_ms,
            }
    return record


def phase_permute_rows(torch, gather) -> dict:
    """K4 against its plain version, bitwise: the beam "off" reorder of one
    large-v3 beam-5 batch-4 cache [32, 20, 68, 20, 64] over a window of 36
    positions (fp8, the record) and whole (bf16), and a tiny f32 and a dev
    fp8 shape."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        ((32, 20, 68, 20, 64), getattr(torch, FP8), 36),
        ((32, 20, 68, 20, 64), torch.bfloat16, 68),
        ((4, 6, 40, 6, 64), torch.float32, 17),
        ((2, 6, 17, 2, 32), getattr(torch, FP8), 9),
    ]
    record = None
    for shape, dt, limit in cases:
        n = shape[1]
        idx = torch.randint(0, n, (n,), generator=gen, device="cuda", dtype=torch.int32)
        idx[-1] = idx[0]
        x = (4 * torch.randn(shape, generator=gen, device="cuda")).to(dt)
        out, ref = torch.zeros_like(x), torch.zeros_like(x)
        xw, ow, rw = x[:, :, :limit], out[:, :, :limit], ref[:, :, :limit]
        gather.permute_rows(xw, idx, out=ow)
        gather.permute_rows_reference(xw, idx, out=rw)
        torch.cuda.synchronize()
        if not torch.equal(_as_bytes(out), _as_bytes(ref)):
            fail(f"K4 differs from its plain version at {list(shape)} {dt} window {limit}")
        err = (out.float() - ref.float()).abs().max().item()
        # Bytes this run's data needs moved: each distinct source row's
        # window read once (a repeated row is served from L2), every
        # destination row's window written.
        n_src = int(torch.unique(idx).numel())
        row_bytes = xw[0, 0].numel() * x.element_size()
        bound = bytes_bound_ms(shape[0] * (n_src + n) * row_bytes)
        kern_ms = time_ms(lambda: gather.permute_rows(xw, idx, out=ow))
        name = str(dt)[6:]
        log(
            f"  K4 {list(shape)} {name} window {limit}: bitwise equal; "
            f"kernel {kern_ms:.4f} ms, bound {bound:.4f} ms (bytes; {n_src} distinct of {n} source rows)"
        )
        if record is None:
            plain_ms = time_ms(lambda: gather.permute_rows_reference(xw, idx, out=rw))
            idx_l = idx.long()
            xb = _as_bytes(x)[:, :, :limit]
            lib_ms = time_ms(lambda: torch.index_select(xb, 1, idx_l))
            # The same call on a permutation without duplicates: every
            # source row read from memory.
            perm = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
            perm_ms = time_ms(lambda: gather.permute_rows(xw, perm, out=ow))
            perm_bound = bytes_bound_ms(shape[0] * 2 * n * row_bytes)
            log(
                f"    plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms; on a permutation "
                f"without duplicates: kernel {perm_ms:.4f} ms, bound {perm_bound:.4f} ms"
            )
            record = {
                "name": "permute_rows", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/permute_rows.cu",
                "replaces": "whisper_tpu/ops/gather.py:71",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms, "shape": list(shape), "dtype": name, "window": limit,
                "distinct_sources": n_src, "permutation_ms": perm_ms,
                "permutation_bound_ms": perm_bound,
            }
    return record


def _within(a, b, tol: float) -> bool:
    """``|a - b| <= tol + tol * |b|`` everywhere (numpy's assert_allclose with
    atol = rtol = tol, as JAX's tests hold K3 to its oracle)."""
    return bool(((a.float() - b.float()).abs() <= tol + tol * b.float().abs()).all())


def phase_gather_attend(torch, gather_attend, fused_step) -> dict:
    """K3 against its plain version at the beam path's shapes (large-v3
    beam 5 batch 4: planes [2, 32, 20, 68, 1280], fp8 and bf16 storage, bf16
    query, pos 4, 35 and 67, both parities, ``idx`` with a duplicate) and at
    a tiny f32 and a dev Dh-32 fp8 shape. The planes bitwise (the write
    plane's window, the read plane, the other layers); ``attn`` within 4
    bf16 ulps at max|ref| (bf16 query) or 1e-5 relative (f32), and against
    ``reference_gather_attend`` (K2's plain version + ``qkv_attention``, the
    hybrid step's read) within JAX's tolerances for its kernel against its
    oracle: f32 1e-5, bf16 3e-2, fp8 5e-2. The record is the fp8 case at pos
    35, timed beside K2 + ``qkv_attention`` (the hybrid step's composite)
    and ``index_select`` + ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from whisper_tpu_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(4)
    dtypes = {"fp8": getattr(torch, FP8), "bf16": torch.bfloat16, "f32": torch.float32}
    oracle_tol = {"fp8": 5e-2, "bf16": 3e-2, "f32": 1e-5}
    cases = [((2, 32, 20, 68, 1280), 20, d, pos) for d in ("fp8", "bf16") for pos in (4, 35, 67)]
    cases += [((2, 4, 6, 40, 384), 6, "f32", 17), ((2, 2, 6, 17, 64), 2, "fp8", 9)]
    record = None
    for shape, n_head, dname, pos in cases:
        _, n_layer, bk, ctx, hd = shape
        dh = hd // n_head
        dt = dtypes[dname]
        q_dt = torch.float32 if dname == "f32" else torch.bfloat16
        idx = torch.randint(0, bk, (bk,), generator=gen, device="cuda", dtype=torch.int32)
        idx[1] = idx[0]  # beam branching: a duplicate, always
        layer = n_layer // 2
        planes = [(4 * torch.randn(shape, generator=gen, device="cuda")).to(dt) for _ in range(2)]
        q = torch.randn((bk, hd), generator=gen, device="cuda").to(q_dt)
        new = [torch.randn((bk, hd), generator=gen, device="cuda") for _ in range(2)]
        err = 0.0
        for parity in (0, 1):
            ck, cv = (p.clone() for p in planes)
            rk, rv = (p.clone() for p in planes)
            ok_, ov_ = (p.clone() for p in planes)
            out, _, _ = gather_attend.fused_gather_attend(ck, cv, idx, layer, pos, parity, q, *new, n_head=n_head)
            ref, _, _ = gather_attend.fused_gather_attend_reference(
                rk, rv, idx, layer, pos, parity, q, *new, n_head=n_head)
            orc, _, _ = gather_attend.reference_gather_attend(
                ok_, ov_, idx, layer, pos, parity, q, *new, n_head=n_head)
            torch.cuda.synchronize()
            w = 1 - parity
            for a, b in ((ck, rk), (cv, rv)):
                same = all(
                    torch.equal(_as_bytes(x), _as_bytes(y))
                    for x, y in ((a[w, layer, :, : pos + 1], b[w, layer, :, : pos + 1]), (a[parity], b[parity]),
                                 (a[w, :layer], b[w, :layer]), (a[w, layer + 1:], b[w, layer + 1:]))
                )
                if not same:
                    fail(f"K3 planes differ from its plain version at {list(shape)} {dname} pos {pos} parity {parity}")
            e = (out.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = bf16_tolerance(ref_max) if q_dt == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
            if not (bool(torch.isfinite(out.float()).all()) and e <= tol):
                fail(f"K3 attn differs from its plain version at {list(shape)} {dname} pos {pos} "
                     f"parity {parity}: {e} > {tol}")
            if not _within(out, orc, oracle_tol[dname]):
                fail(f"K3 attn differs from reference_gather_attend at {list(shape)} {dname} pos {pos} "
                     f"beyond {oracle_tol[dname]}")
            err = max(err, e)
        # Bytes this run's data needs moved: K2's (each distinct source row
        # of the window read once, the new rows read, the window [0, pos] of
        # every row written; K and V), plus q read and attn written.
        # Operations: 4·BK·pos·HD (scores and values) at the query dtype's
        # peak rate. Timed on new rows already in the storage dtype; the
        # wrapper's casts of f32 rows are timed beside it.
        isz = planes[0].element_size()
        n_src = int(torch.unique(idx).numel())
        qo_bytes = 2 * bk * hd * q.element_size()
        peak = PEAK_BF16_FLOPS if q_dt == torch.bfloat16 else PEAK_F32_FLOPS
        by_ops = 4.0 * bk * pos * hd / peak * 1e3
        bound = max(bytes_bound_ms(2 * hd * isz * (n_src * pos + bk + bk * (pos + 1)) + qo_bytes), by_ops)
        stored = [n.to(dt) for n in new]
        kern_ms = time_ms(lambda: gather_attend.fused_gather_attend(
            ck, cv, idx, layer, pos, 0, q, *stored, n_head=n_head))
        log(
            f"  K3 {list(shape)} {dname} pos {pos}: planes bitwise equal, attn max_abs_err {err:.3g} "
            f"(both parities; within {oracle_tol[dname]} of reference_gather_attend); "
            f"kernel {kern_ms:.4f} ms, bound {bound:.4f} ms (bytes; {n_src} distinct of {bk} source rows)"
        )
        if record is None and pos == 35:
            cast_ms = time_ms(lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, layer, pos, 0, q, *new, n_head=n_head))
            plain_ms = time_ms(lambda: gather_attend.fused_gather_attend_reference(
                ck, cv, idx, layer, pos, 0, q, *stored, n_head=n_head))
            qh = q.view(bk, 1, n_head, dh)

            def hybrid():  # the hybrid step's read: K2, then qkv_attention over [0, pos]
                fused_step.permute_append(ck, cv, idx, layer, pos, 0, *stored)
                k, v = (p[1, layer, :, : pos + 1].view(bk, pos + 1, n_head, dh) for p in (ck, cv))
                return layers.qkv_attention(qh, k, v, None)

            hybrid_ms = time_ms(hybrid)
            idx_l = idx.long()
            qt = q.view(bk, n_head, 1, dh)

            srcs = [_as_bytes(p)[0, layer, :, :pos] for p in (ck, cv)]

            def library():  # index_select of the K and V windows, upcast, one SDPA
                k, v = (
                    torch.index_select(s_, 0, idx_l).view(dt).to(q_dt).view(bk, pos, n_head, dh).transpose(1, 2)
                    for s_ in srcs
                )
                return F.scaled_dot_product_attention(qt, k, v)

            lib_ms = time_ms(library)
            perm = torch.randperm(bk, generator=gen, device="cuda").to(torch.int32)
            perm_ms = time_ms(lambda: gather_attend.fused_gather_attend(
                ck, cv, perm, layer, pos, 0, q, *stored, n_head=n_head))
            perm_bound = max(bytes_bound_ms(2 * hd * isz * (bk * pos + bk + bk * (pos + 1)) + qo_bytes), by_ops)
            log(
                f"    with the f32 rows' casts {cast_ms:.4f} ms; plain {plain_ms:.4f} ms; hybrid composite "
                f"(K2 + qkv_attention) {hybrid_ms:.4f} ms; index_select ×2 + upcast ×2 + "
                f"scaled_dot_product_attention (window [0, pos) only, no append) {lib_ms:.4f} ms; on a "
                f"permutation without duplicates: kernel {perm_ms:.4f} ms, bound {perm_bound:.4f} ms"
            )
            record = {
                "name": "gather_attend", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/gather_attend.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:328",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if bound > by_ops else "operations",
                "library_ms": lib_ms,
                "library_call": "index_select x2 + .to(bfloat16) x2 + scaled_dot_product_attention",
                "hybrid_ms": hybrid_ms, "cast_ms": cast_ms,
                "shape": list(shape), "dtype": FP8, "pos": pos, "distinct_sources": n_src,
                "permutation_ms": perm_ms, "permutation_bound_ms": perm_bound,
            }
    return record


def phase_mel_fused(torch, mel_fused) -> dict:
    """K5 against its plain version on the main path's batch ([4, 480000],
    128 mels, the large-v3 frontend), on [2, 480000] with 80 mels and on one
    unbatched [480000]: max abs error ≤ 2e-4 in log-mel units (JAX's
    tolerance for its fused kernel, tests/test_mel.py), and the same against
    the engine's ``frontend/mel.log_mel_spectrogram``. The unbatched
    utterance is the batch's row 3: the kernel's output must equal that
    row bitwise, and the plain version's two results are compared too. The
    first call is K5's path: one call of its entry point, launches counted.
    Times: the kernel alone, the wrapper with its epilogue, the plain
    version, the library composite (``torch.stft`` on cuFFT, the mel
    matmul on constants already on the card, ``log10``; checked against the
    kernel within the same 2e-4), and ``frontend/mel.py``'s host wall time
    (it uploads its constants on every call)."""
    import torch.nn.functional as F

    from whisper_tpu_torch.frontend.mel import log_mel_spectrogram

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' matmuls in full f32
    _, batch, _ = main_path_batch()
    x4 = torch.from_numpy(batch).cuda()
    cases = [("main path batch", x4, 128), ("[2, 480000]", x4[:2].flip(-1).contiguous(), 80),
             ("unbatched", x4[3], 128)]
    tol = 2e-4
    launches = None
    record = None
    batched = None
    reset_counts(mel_fused)  # counts start here: K5's path (the first case's call)
    for name, x, n_mels in cases:
        out = mel_fused.log_mel_spectrogram_fused(x, n_mels=n_mels)
        torch.cuda.synchronize()
        if launches is None:
            launches = mel_fused.launches  # counts end here
            if launches != 1:
                fail(f"K5 launched {launches} times for one batch, expected 1")
        ref = mel_fused.log_mel_spectrogram_fused_reference(x, n_mels=n_mels)
        eng = log_mel_spectrogram(x, n_mels=n_mels)
        err = (out - ref).abs().max().item()
        err_eng = (out - eng).abs().max().item()
        log(f"  K5 {name} {list(x.shape)} {n_mels} mels: max_abs_err {err:.3g} vs plain, "
            f"{err_eng:.3g} vs frontend/mel.py (tol {tol})")
        if out.shape != (*x.shape[:-1], n_mels, 3000) or not bool(torch.isfinite(out).all()):
            fail(f"K5 output malformed at {name}: {tuple(out.shape)}")
        if err > tol or err_eng > tol:
            fail(f"K5 differs at {name}: {err} / {err_eng} > {tol}")
        if batched is None:
            batched = (out, ref, eng)
        if name == "unbatched":  # which side moves between batch 4 and batch 1
            same = torch.equal(out, batched[0][3])
            plain_moved = (ref - batched[1][3]).abs().max().item()
            eng_moved = (eng - batched[2][3]).abs().max().item()
            log(f"    unbatched against the batch's row 3: kernel bitwise {same}; plain version moved "
                f"{plain_moved:.3g}, frontend/mel.py moved {eng_moved:.3g}")
            if not same:
                fail("K5's output for one utterance differs from its row in the batch")
            record["unbatched_plain_moved"] = plain_moved
            record["unbatched_frontend_mel_moved"] = eng_moved
        if record is None:
            b = x.shape[0]
            filt_t = mel_fused._basis(n_mels)[1][:, :n_mels]
            bound = mel_bound(b, n_mels, int(np.count_nonzero(filt_t)))
            kern_ms = time_ms(lambda: mel_fused.log10_mel_kernel(x, n_mels))
            wrap_ms = time_ms(lambda: mel_fused.log_mel_spectrogram_fused(x, n_mels=n_mels))
            plain_ms = time_ms(lambda: mel_fused.log_mel_spectrogram_fused_reference(x, n_mels=n_mels))
            window = torch.hann_window(400, periodic=True, device="cuda")
            filt = torch.from_numpy(filt_t.T.copy()).cuda()  # [n_mels, 201], the fold pre-scaled

            def library():  # the kernel's function: cuFFT stft, |.|^2, the mel matmul, log10
                spec = torch.stft(F.pad(x, (0, 240)), 400, 160, window=window, center=False,
                                  return_complex=True)  # [b, 201, 3000]
                return torch.log10(torch.clamp_min(filt @ spec.abs().square(), 1e-10))

            lib_err = (mel_fused._epilogue(library(), x.shape[:-1]) - out).abs().max().item()
            if not lib_err <= tol:
                fail(f"K5's library composite differs from the kernel: {lib_err} > {tol}")
            lib_ms = time_ms(library)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                log_mel_spectrogram(x, n_mels=n_mels)
            torch.cuda.synchronize()
            fe_wall_ms = (time.perf_counter() - t0) * 1e3 / 10
            log(f"    kernel {kern_ms:.4f} ms, with the torch epilogue {wrap_ms:.4f} ms; bound "
                f"{bound['ms']:.4f} ms ({bound['by']}; rFFT + filterbank non-zeros {bound['gflop']:.3f} "
                f"GFLOP); the kernel's dense DFT {bound['dense_gflop']:.2f} GFLOP, "
                f"{bound['dense_gflop'] / kern_ms:.1f} TFLOP/s, its own least time {bound['dense_ms']:.4f} ms; "
                f"plain {plain_ms:.4f} ms; torch.stft + mel matmul + log10 (cuFFT, cuBLAS, several calls; "
                f"max_abs_err {lib_err:.3g} vs the kernel) {lib_ms:.4f} ms; frontend/mel.py host wall "
                f"time (uploads its constants per call) {fe_wall_ms:.4f} ms")
            record = {
                "name": "log_mel_fused", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/log_mel_fused.cu",
                "replaces": "whisper_tpu/frontend/mel_pallas.py:102",
                "launches": launches, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound["ms"], "bound_by": bound["by"],
                "library_ms": lib_ms,
                "library_call": "torch.stft (cuFFT) + abs().square() + mel matmul + log10, several calls",
                "library_max_abs_err": lib_err, "bound_gflop": bound["gflop"],
                "dense_dft_gflop": bound["dense_gflop"], "dense_dft_least_ms": bound["dense_ms"],
                "wrapper_ms": wrap_ms, "frontend_mel_wall_ms": fe_wall_ms,
                "shape": list(x.shape), "n_mels": n_mels, "max_abs_err_vs_frontend_mel": err_eng,
            }
    return record


def phase_probe_fused(torch, kernels, probe_fused) -> int:
    """K3's path at full width: ``probe_fused.run`` at large-v3, batch 4,
    beam 5, ctx 68, fp8 planes, in each mode. K3 launches 32 × steps under
    "attend" and never otherwise; K2 32 × steps under "dma" and "hybrid".
    Then one step of "attend" and one of "hybrid" from the same seed gather
    bitwise-equal windows and give ``h`` within the tolerance of
    ``probe_fused.compare_runs``. Returns K3's launches under "attend"."""
    attention, fused_step, gather, gather_attend, mel_fused = kernels
    args = dict(model="large-v3", batch=4, beam=5, ctx=68, kv=FP8)
    k3_launches = None
    for mode in probe_fused.MODES:
        reset_counts(*kernels)  # counts start here: this mode's run
        res = probe_fused.run(**args, iters=8, warmup=1, mode=mode)
        torch.cuda.synchronize()
        k3, k2 = gather_attend.launches, fused_step.launches
        others = (attention.launches + gather.launches + mel_fused.launches
                  + fused_step.sharded_launches)  # counts end here
        expect = LARGE_V3_DEC_LAYERS * res["steps"]
        log(f"  {mode}: {res['ms_per_step']:.4f} ms per {res['layers']}-layer step "
            f"({res['gb'] / res['ms_per_step'] * 1e3:.0f} GB/s of {res['gb']:.3f} GB r+w); "
            f"K3 {k3}, K2 {k2} launches over {res['steps']} steps")
        if not bool(torch.isfinite(res["h"].float()).all()):
            fail(f"probe {mode}: h not finite")
        want = (expect, 0) if mode == "attend" else (0, expect)
        if (k3, k2) != want or others or res["layers"] != LARGE_V3_DEC_LAYERS:
            fail(f"probe {mode}: K3 {k3}, K2 {k2}, others {others}; expected K3, K2 = {want}")
        if mode == "attend":
            k3_launches = k3
    one = dict(args, iters=1, warmup=0)
    cmp = probe_fused.compare_runs(probe_fused.run(**one, mode="attend"), probe_fused.run(**one, mode="hybrid"))
    torch.cuda.synchronize()
    log(f"  one step, attend vs hybrid: gathered windows bitwise {cmp['gathered_equal']}, h max_abs_err "
        f"{cmp['h_err']:.3g} (tol {cmp['h_tol']:.3g}), new rows {cmp['new_rows_err']:.3g} "
        f"(tol {cmp['new_rows_tol']:.3g})")
    if not cmp["ok"]:
        fail(f"probe: attend and hybrid disagree after one step: {cmp}")
    return k3_launches


def synthetic_utterance(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (180 + 40 * seed) * t) * (1 + np.sin(2 * np.pi * 3 * t))
    return (x + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def check_results(results, engine, n_vocab) -> None:
    p_len = len(engine._prompt)
    total = p_len + engine._max_new
    sot, eot = engine.vocab.specials.sot, engine.vocab.specials.eot
    for r in results:
        toks = np.asarray(r.tokens)
        if toks.shape != (total,) or not (p_len < r.length <= total):
            fail(f"malformed result: shape {toks.shape}, length {r.length}")
        if toks[0] != sot or not (sot < toks[1] <= sot + 100):
            fail(f"prompt not [sot, <lang>, ...]: {toks[:p_len]}")
        if toks.min() < 0 or toks.max() >= n_vocab or (toks[r.length:] != eot).any():
            fail("token ids out of range or tail not EOT")
        if not isinstance(r.text, str) or not r.language:
            fail("missing text or language")


LENGTHS_S = (4.0, 11.0, 19.5, 30.0)


def main_path_batch():
    utts = [synthetic_utterance(s, i) for i, s in enumerate(LENGTHS_S)]
    batch = np.zeros((4, 480_000), np.float32)
    for i, u in enumerate(utts):
        batch[i, : len(u)] = u
    return utts, batch, float(sum(LENGTHS_S))


def reset_counts(*modules) -> None:
    for m in modules:
        m.launches = 0
        if hasattr(m, "sharded_launches"):  # K2′ counts beside K2 in ops/fused_step.py
            m.sharded_launches = 0


def phase_main_path(torch, kernels, EngineConfig, EngineType, create_engine) -> int:
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather, gather_attend, mel_fused = kernels
    cfg = EngineConfig(model="large-v3", max_new_tokens=64)
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    dims = engine.dims
    utts, batch, audio_s = main_path_batch()

    reset_counts(*kernels)  # counts start here: the main path's run
    encodes = 0
    results = engine.transcribe_batch(batch)  # first call: warms the libraries
    encodes += 1
    check_results(results, engine, dims.n_vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.transcribe_batch(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    encodes += 1
    check_results(results, engine, dims.n_vocab)

    # Stage breakdown on the same batch, through the engine's own stages.
    host, _, _ = engine._prepare_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_out = engine._encode(host, engine._resolve_audio_ctx(host))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens, lengths, _, _ = engine._decode(enc_out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    encodes += 1
    steps = int(lengths.max().item()) - len(engine._prompt)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "utterance.wav")
        write_wav(path, utts[1])
        single = engine.transcribe(path)
    encodes += 1
    check_results([single], engine, dims.n_vocab)
    launches = attention.launches  # counts end here
    others = (fused_step.launches, gather.launches, gather_attend.launches, mel_fused.launches,
              fused_step.sharded_launches)
    if any(others):
        fail(f"greedy launched K2, K4, K3, K5, K2′ {others} times, expected none")

    log(
        f"  large-v3 bf16, batch 4 ({audio_s:.1f} s of audio): {wall * 1e3:.1f} ms "
        f"→ {audio_s / wall:.2f} audio-s/s; mel+encoder {(t1 - t0) * 1e3:.1f} ms, "
        f"decode {(t2 - t1) * 1e3:.1f} ms over {steps} steps "
        f"= {(t2 - t1) * 1e3 / max(steps, 1):.2f} ms/token"
    )
    for r in results:
        log(f"    lang {r.language} length {r.length} tokens {r.tokens[:8].tolist()}...")
    log(f"    file: lang {single.language} length {single.length}")
    expected = LARGE_V3_ENC_LAYERS * encodes
    log(f"  K1 launches on the main path: {launches} ({encodes} encodes × {dims.n_audio_layer} layers)")
    if dims.n_audio_layer != LARGE_V3_ENC_LAYERS or launches != expected:
        fail(f"K1 launched {launches} times, expected {expected}")
    return launches


def phase_beam_path(torch, kernels, beam, EngineConfig, EngineType, create_engine) -> tuple:
    """Beam main path (docstring, phase 4b). Returns the K2 and K4 launch
    counts of their runs, the hybrid engine and its batch's results."""
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather, gather_attend, mel_fused = kernels
    cfg = EngineConfig(
        model="large-v3", beam_size=5, quantization="int8", kv_cache_dtype=FP8,
        max_new_tokens=64,
    )
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    dims = engine.dims
    utts, batch, audio_s = main_path_batch()

    reset_counts(*kernels)  # counts start here: the beam main path's run
    beam.steps = 0
    encodes = 0
    results = engine.transcribe_batch(batch)  # first call: warms the libraries
    encodes += 1
    check_results(results, engine, dims.n_vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.transcribe_batch(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    encodes += 1
    check_results(results, engine, dims.n_vocab)
    host, _, _ = engine._prepare_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_out = engine._encode(host, engine._resolve_audio_ctx(host))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps_before = beam.steps
    engine._decode(enc_out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    encodes += 1
    stage_steps = beam.steps - steps_before
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "utterance.wav")
        write_wav(path, utts[1])
        single = engine.transcribe(path)
    encodes += 1
    check_results([single], engine, dims.n_vocab)
    k1, k2, k4, steps = attention.launches, fused_step.launches, gather.launches, beam.steps
    k3, k5, k2s = gather_attend.launches, mel_fused.launches, fused_step.sharded_launches
    # counts end here

    log(
        f"  large-v3 beam 5 int8 + fp8 KV, batch 4 ({audio_s:.1f} s of audio): "
        f"{wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; mel+encoder "
        f"{(t1 - t0) * 1e3:.1f} ms, decode {(t2 - t1) * 1e3:.1f} ms over {stage_steps} "
        f"steps = {(t2 - t1) * 1e3 / max(stage_steps, 1):.2f} ms/step"
    )
    for r in results:
        log(f"    lang {r.language} length {r.length} avg_logprob {r.avg_logprob:.4f} tokens {r.tokens[:8].tolist()}...")
    log(f"    file: lang {single.language} length {single.length}")
    log(
        f"  launches on the beam path: K1 {k1} ({encodes} encodes × {dims.n_audio_layer} layers), "
        f"K2 {k2} ({steps} steps × {dims.n_text_layer} layers), K4 {k4}"
    )
    if dims.n_text_layer != LARGE_V3_DEC_LAYERS or steps == 0:
        fail(f"no decode steps ran ({steps}) or the decoder has {dims.n_text_layer} layers")
    if k1 != LARGE_V3_ENC_LAYERS * encodes:
        fail(f"K1 launched {k1} times, expected {LARGE_V3_ENC_LAYERS * encodes}")
    if k3 or k5 or k2s:
        fail(f"hybrid: K3 launched {k3} times, K5 {k5}, K2′ {k2s}, expected none")
    if k2 != LARGE_V3_DEC_LAYERS * steps or k4 != 0:
        fail(f"hybrid: K2 launched {k2} times (expected {LARGE_V3_DEC_LAYERS * steps}), K4 {k4} (expected 0)")

    # The same weights with the eager step and the K4 reorder.
    off = type(engine)(engine.assets, dataclasses.replace(cfg, fused_step="off"), device="cuda")
    reset_counts(*kernels)  # counts start here: the "off" run
    beam.steps = 0
    t0 = time.perf_counter()
    results_off = off.transcribe_batch(batch)
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t0
    k2_off, k4_off, steps_off = fused_step.launches, gather.launches, beam.steps
    k35_off = gather_attend.launches + mel_fused.launches
    # counts end here
    log(
        f"  fused_step='off': {wall_off * 1e3:.1f} ms → {audio_s / wall_off:.2f} audio-s/s; "
        f"K2 {k2_off}, K4 {k4_off} ({steps_off} steps × 2)"
    )
    if k2_off != 0 or k35_off != 0 or k4_off != 2 * steps_off or steps_off == 0:
        fail(f"off: K2 launched {k2_off} times (expected 0), K4 {k4_off} (expected {2 * steps_off})")
    for a, b in zip(results, results_off):
        if not np.array_equal(a.tokens, b.tokens) or a.length != b.length:
            fail(f"hybrid and off tokens differ: {a.tokens[:a.length].tolist()} vs {b.tokens[:b.length].tolist()}")
    log("  hybrid and off tokens equal")
    return k2, k4_off, engine, results


def phase_data_parallel(torch, beam_engine, beam_results) -> list:
    """The flagship data-parallel path (docstring, phase 4d). Returns K2′'s
    launches on each rank."""
    from whisper_tpu_torch.parallel._dist_worker import launch, params_checksum

    cfg = beam_engine.config
    _, batch, audio_s = main_path_batch()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "batch.npy"), batch)
        reports = launch(2, [
            "--npy", os.path.join(tmp, "batch.npy"), "--model", cfg.model, "--seed", "0",
            "--device", "cuda", "--dtype", cfg.dtype, "--beam", str(cfg.beam_size),
            "--quantization", cfg.quantization, "--kv-cache-dtype", cfg.kv_cache_dtype,
            "--fused-step", "auto", "--max-new", str(cfg.max_new_tokens),
        ], tmp, timeout=600)
    checksum = params_checksum(beam_engine.assets.params)
    k2s = []
    for rep in reports:
        run = rep["runs"]["auto"]
        n, steps = run["launches"], run["steps"]
        rows_s = sum(LENGTHS_S[2 * rep["rank"]: 2 * rep["rank"] + 2])
        log(f"  rank {rep['rank']} of {rep['world']} on {rep['device']} ({rep['device_name']}): "
            f"{run['seconds'] * 1e3:.1f} ms for its 2 rows ({rows_s:.1f} s of audio) → "
            f"{rows_s / run['seconds']:.2f} audio-s/s; launches K1 {n['flash_attn_fwd']}, "
            f"K2 {n['permute_append']}, K2′ {n['permute_append_sharded']} ({steps} steps × "
            f"{LARGE_V3_DEC_LAYERS} layers), K4 {n['permute_rows']}; weights checksum "
            f"{rep['params_checksum']}")
        if rep["params_checksum"] != checksum:
            fail(f"rank {rep['rank']} holds other weights than phase 4b: {rep['params_checksum']} != {checksum}")
        if steps == 0 or n["permute_append_sharded"] != LARGE_V3_DEC_LAYERS * steps:
            fail(f"rank {rep['rank']}: K2′ launched {n['permute_append_sharded']} times over {steps} steps")
        if n["permute_append"] or n["permute_rows"] or n["flash_attn_fwd"] != LARGE_V3_ENC_LAYERS * run["encodes"]:
            fail(f"rank {rep['rank']}: K2 {n['permute_append']}, K4 {n['permute_rows']} (expected 0), "
                 f"K1 {n['flash_attn_fwd']} (expected {LARGE_V3_ENC_LAYERS * run['encodes']})")
        k2s.append(n["permute_append_sharded"])
    results = reports[0]["runs"]["auto"]["results"]
    if reports[1]["runs"]["auto"]["results"] != results or len(results) != len(LENGTHS_S):
        fail("the ranks returned different result lists")
    wall = max(rep["runs"]["auto"]["seconds"] for rep in reports)
    log(f"  both ranks: the same {len(results)} results; {audio_s / wall:.2f} audio-s/s over the "
        f"slower rank (two ranks share one card: not a scaling number)")
    # Each rank's rows against one process running the same rows at the
    # same per-rank batch shape, with the crop the ranks resolved from the
    # whole batch: the same kernels on the same shapes, so exactly equal.
    single = type(beam_engine)(
        beam_engine.assets, dataclasses.replace(cfg, audio_ctx=reports[0]["audio_ctx"]),
        device=beam_engine.device,
    )
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        for g, s_ in zip(results[rows], single.transcribe_batch(batch[rows])):
            if g["tokens"] != s_.tokens[: s_.length].tolist() or g["length"] != s_.length:
                fail(f"rank {r}'s rows differ from a single-process run of them: {g['tokens']} vs "
                     f"{s_.tokens[: s_.length].tolist()}")
    log(f"  each rank's rows equal a single-process run of the same rows at batch 2 "
        f"(audio_ctx {reports[0]['audio_ctx']})")
    agree = sum(g["tokens"] == b.tokens[: b.length].tolist() for g, b in zip(results, beam_results))
    log(f"  information: {agree} of {len(results)} rows equal phase 4b's single-process batch-4 run")
    return k2s


def phase_card_vs_cpu(torch, EngineConfig, Monolith) -> None:
    from whisper_tpu_torch.models.params import init_params

    # float32 on both sides: TF32 off for matmuls and for cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EngineConfig(model="tiny", dtype="float32", max_new_tokens=24)
    params = init_params(cfg.dims(), torch.Generator().manual_seed(1))
    x = np.zeros((2, 480_000), np.float32)
    x[0, :64_000] = synthetic_utterance(4.0, 5)
    x[1] = synthetic_utterance(30.0, 6)
    card = Monolith.from_assets(params, cfg, device="cuda").transcribe_batch(x)
    cpu = Monolith.from_assets(params, cfg, device="cpu").transcribe_batch(x)
    for a, b in zip(card, cpu):
        log(f"  card {a.tokens[: a.length].tolist()}")
        log(f"  cpu  {b.tokens[: b.length].tolist()}")
        if not np.array_equal(a.tokens, b.tokens) or a.language != b.language:
            fail("tiny f32: tokens on the card differ from the CPU's")

    def beam_run(device, fused, **extra):
        c = dataclasses.replace(cfg, beam_size=3, fused_step=fused, **extra)
        return Monolith.from_assets(params, c, device=device).transcribe_batch(x)

    runs = {
        "card hybrid": beam_run("cuda", "hybrid"),
        "card off": beam_run("cuda", "off"),
        "cpu off": beam_run("cpu", "off"),
    }
    q8 = dict(quantization="int8", kv_cache_dtype=FP8)
    runs_q = {
        "card hybrid int8+fp8": beam_run("cuda", "hybrid", **q8),
        "cpu off int8+fp8": beam_run("cpu", "off", **q8),
    }
    for group in (runs, runs_q):
        (first, ref), *rest = group.items()
        for r in ref:
            log(f"  beam 3, {first}: {r.tokens[: r.length].tolist()}")
        for name, res in rest:
            for a, b in zip(ref, res):
                if not np.array_equal(a.tokens, b.tokens) or a.language != b.language:
                    fail(f"tiny f32 beam 3: {name} tokens {b.tokens[: b.length].tolist()} differ from {first}'s")
            log(f"  beam 3, {name}: equal")

    # Two ranks on the card (mesh_shape=(2, 1)), both step modes, against
    # the CPU's single-process run.
    from whisper_tpu_torch.parallel._dist_worker import launch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(params, os.path.join(tmp, "params.pt"))
        np.save(os.path.join(tmp, "x.npy"), x)
        reports = launch(2, [
            "--npy", os.path.join(tmp, "x.npy"), "--params", os.path.join(tmp, "params.pt"),
            "--model", cfg.model, "--device", "cuda", "--dtype", cfg.dtype, "--beam", "3",
            "--fused-step", "hybrid,off", "--max-new", str(cfg.max_new_tokens),
        ], tmp, timeout=300)
    layers = cfg.dims().n_text_layer
    for mode in ("hybrid", "off"):
        for rep in reports:
            run = rep["runs"][mode]
            n, steps = run["launches"], run["steps"]
            for g, b in zip(run["results"], runs["cpu off"]):
                if g["tokens"] != b.tokens[: b.length].tolist():
                    fail(f"tiny f32 beam 3, DP(2) {mode} on the card, rank {rep['rank']}: tokens "
                         f"{g['tokens']} differ from the CPU's {b.tokens[: b.length].tolist()}")
            want = (layers * steps, 0) if mode == "hybrid" else (0, 2 * steps)
            if steps == 0 or (n["permute_append_sharded"], n["permute_rows"]) != want or n["permute_append"]:
                fail(f"tiny DP(2) {mode}, rank {rep['rank']}: K2′ {n['permute_append_sharded']}, "
                     f"K4 {n['permute_rows']}, K2 {n['permute_append']} over {steps} steps")
        log(f"  beam 3, DP(2) on the card, {mode}: both ranks equal to cpu off "
            f"(K2′ {reports[0]['runs'][mode]['launches']['permute_append_sharded']} launches on rank 0)")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    t_start = time.perf_counter()
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import beam
    from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
    from whisper_tpu_torch.frontend import mel_fused
    from whisper_tpu_torch.ops import attention, build, fused_step, gather, gather_attend
    from whisper_tpu_torch.utils import probe_fused

    log("[1] card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}; capability {cap}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    log("[2] build")
    t0 = time.perf_counter()
    kernels = (attention, fused_step, gather, gather_attend, mel_fused)
    built = build.build([k.KERNEL for k in kernels])
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (secs, ptxas) in built.items():
        usage = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))

    log("[3] kernels against their plain versions")
    k1, k2, k4 = (
        phase_kernels(torch, attention),
        phase_permute_append(torch, fused_step),
        phase_permute_rows(torch, gather),
    )
    k2s = phase_permute_append_sharded(torch, fused_step)
    k3 = phase_gather_attend(torch, gather_attend, fused_step)
    k5 = phase_mel_fused(torch, mel_fused)

    log("[4] main path: large-v3, greedy, bf16, language detection")
    k1["launches"] = phase_main_path(
        torch, kernels, EngineConfig, EngineType, create_engine
    )

    log("[4b] beam main path: large-v3, beam 5, int8 weights, fp8 KV cache, bf16")
    k2["launches"], k4["launches"], beam_engine, beam_results = phase_beam_path(
        torch, kernels, beam, EngineConfig, EngineType, create_engine
    )

    log("[4c] K3's path: probe_fused at large-v3, batch 4, beam 5, ctx 68, fp8 planes")
    k3["launches"] = phase_probe_fused(torch, kernels, probe_fused)

    log("[4d] data-parallel path: large-v3, beam 5, int8, fp8 KV, mesh_shape=(2, 1), two ranks on one card")
    per_rank = phase_data_parallel(torch, beam_engine, beam_results)
    k2s["launches"], k2s["launches_per_rank"] = sum(per_rank), per_rank
    del beam_engine

    log("[5] card against CPU: tiny, float32, TF32 off")
    phase_card_vs_cpu(torch, EngineConfig, Monolith)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k2s, k3, k4, k5]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
