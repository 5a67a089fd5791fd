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
   ``reference_gather_attend``, with f32 and bf16 new rows, which the
   kernel converts itself: one kernel per call (profiler), timed with bf16
   rows as ``utils/probe_fused.py`` passes them, at pos 4 (its floor) and
   beside K2 on the same call; K5: 2e-4 in log-mel units, also against
   ``frontend/mel.py``, its rate on its own operation count); times of
   the kernel, the plain version and the library call (or the nearest
   composite, labelled) beside the bound;
   K1 and ``scaled_dot_product_attention`` also at T = 256, 512, 1024 and
   1500 at large-v3 width (batch 4, 20 heads), one line per T.
   K5's path is its entry point on the main path's batch: one launch. K2′
   (K2 on one rank of a data-parallel mesh) bitwise on rank 1's planes of
   a batch of 4 on 2 ranks, with global source rows. K2 and K2′ with new
   rows in f32, bf16 and strided bf16, which the kernel converts itself:
   one kernel per call (profiler), timed with bf16 rows as the engine
   passes them, beside the launch floor (``torch.cuda._sleep(0)``) and the
   wrapper's host time; the conversion bitwise equal to ``.to()`` over
   every bf16 and f16 pattern and f32 edge values; K2 over pos 35, 100,
   200 and 440 of the flagship's full 448-token context, on fp8 planes (bf16
   rows and rows already in fp8) and on bf16 planes (bf16 rows, the
   default config's cache); K3 over the same points beside K2, checked
   against its plain version at each.

    python3 chip_smoke.py --sweep-tree DIR   # the K2 and K3 sweeps and K5's times alone, DIR's kernels
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
   and "off" against CPU "off". Then serving, ``audio_ctx=None``, on
   int16-exact utterances: ``ContinuousTranscriber`` (2 slots, 5
   utterances: slots reused), ``DisaggregatedTranscriber`` and
   ``AsyncTranscriber`` must each give tokens equal to ``engine.transcribe``
   on the card and to the same class on the CPU; the slot pool with the fp8
   KV cache (its per-row byte scatter) card against CPU. And the options of
   PR 9, card against CPU: tokens through the sampler at T = 0 (a ladder
   with both gates off) equal on both and to the argmax path's; words of
   ``word_timestamps=True`` (over a vocab whose ids from 256 up are each a
   word) equal; ``transcribe_sequential`` of 35 s: tokens and segments
   equal. (The noise of T > 0 is the device's own stream: Philox on the
   card, MT19937 on the CPU, so sampled tokens are not compared.)
6. Serving at full width, large-v3 (``engine/serving.py``,
   ``engine/http_server.py``):
6a. The slot pool: greedy bf16, ``audio_ctx=None``, phase 4's weights,
   64-token budget; ``ContinuousTranscriber(n_slots=8, prefill_batch=2)``,
   then ``DisaggregatedTranscriber`` with the same arguments, each given 12
   utterances of 2–30 s in three waves (one result of a wave awaited before
   the next is submitted). Every future resolves within its timeout and
   passes ``check_results``; K1 launches exactly 32 × the prefill
   dispatches, K2, K2′, K3, K4 and K5 never. Prints request latency p50/p95
   (submit → result), audio-s/s, occupancy, dispatch efficiency and
   macro-steps, and (information only) token agreement with
   ``engine.transcribe`` of each utterance.
6b. ``AsyncTranscriber(max_batch=4)`` over phase 4b's flagship engine, 8
   utterances from 4 threads: K1 32 × flushes, K2 32 × beam steps, K3, K4,
   K5 and K2′ never; latency p50/p95 and audio-s/s.
6c. ``TranscribeServer`` in "continuous" mode on ``127.0.0.1:0`` over the
   6a engine: one WAV and one raw-PCM POST, each response's text equal to
   the same slot pool's result for that audio; ``/metrics`` reports 2
   requests, 0 errors and a non-zero throughput.

7. The options of ``transcribe`` at full width, large-v3, phase 4's and 4b's
   weights; every launch count set to 0 just before each sub-phase and
   checked exactly just after it:
7a. Greedy bf16 with the default ladder (0.0, 0.2, …, 1.0) and the default
   gates on phase 4's 4 utterances, 64-token budget: every temperature in
   the schedule, the runs (one encode each) matching the kept temperatures,
   rows retried per attempt printed; K1 32 × the encodes, K2, K2′, K3, K4,
   K5 never. Then the ladder with both gates off: one run through the
   sampler at T = 0, tokens equal to phase 4's.
7b. The flagship (beam 5, int8, fp8 KV, "auto") with the same ladder: K2
   32 × the beam steps of the primary (the retries sample), K1 as in 7a.
7c. ``word_timestamps=True`` on phase 4's batch (a vocab whose ids from
   256 up are each a word): tokens equal to phase 4's, K1 32 (the
   alignment forward reuses the primary's encoder output), words ordered
   within [0, 30 s] (the DTW spans the batch's frames, as in JAX); the
   alignment forward's ms and the DTW's host ms per row; then the 4 s
   utterance alone: its words within [0, 4 s].
7d. ``transcribe_long`` of 75 s of synthetic bursts and near-silence (VAD
   chunks in one batch: K1 32), offsets increasing; ``transcribe_sequential``
   of 35 s with a 16-token budget and language detection: at most 35
   windows, K1 32 × (windows + 1), segments ordered.

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
    and the log (1 per mel)."""
    frames = b * 3000
    n = 400
    flops = frames * (n + 2.5 * n * np.log2(n) + 3 * 201 + 2 * filt_nnz + n_mels)
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    by_bytes = bytes_bound_ms(b * (480_000 + n_mels * 3000) * 4)
    bound, by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return {"ms": bound, "by": by, "gflop": float(flops) / 1e9}


def kernels_per_call(torch, fn, traces: int = 3) -> list:
    """The names of the device kernels one call of ``fn`` launches, from a
    ``torch.profiler`` trace of that call alone. A trace that holds no
    device event at all recorded nothing (the profiler at times returns an
    empty trace right after another session): it is taken again, up to
    ``traces`` times, and an empty list comes back only if every trace was
    empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: libraries loaded, allocator primed
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        log("  (the profiler's trace held no device event: taken again)")
    return names


def _k2_rows(torch, gen, bk, hd):
    """New K/V rows as the engine passes them (bf16), in f32, and as a
    column slice of a wider bf16 tensor (strided rows)."""
    f32 = [torch.randn((bk, hd), generator=gen, device="cuda") for _ in range(2)]
    wide = torch.randn((2, bk, 2 * hd), generator=gen, device="cuda").to(torch.bfloat16)
    return {"f32": f32, "bf16": [r.to(torch.bfloat16) for r in f32],
            "bf16 strided": [wide[0, :, 3 : 3 + hd], wide[1, :, hd - 1 : 2 * hd - 1]]}


def _k2_contract_equal(torch, a, b, layer, pos, parity) -> bool:
    """The write plane's window [0, pos], the read plane and the write
    plane's other layers agree bitwise (past pos the write plane is
    unspecified)."""
    w = 1 - parity
    return all(
        torch.equal(_as_bytes(x), _as_bytes(y))
        for x, y in ((a[w, layer, :, : pos + 1], b[w, layer, :, : pos + 1]), (a[parity], b[parity]),
                     (a[w, :layer], b[w, :layer]), (a[w, layer + 1:], b[w, layer + 1:]))
    )


def k2_bound_ms(hd, isz, row_isz, n_src, bk, pos) -> float:
    """Bytes this call needs moved, K and V: each distinct source row of the
    window [0, pos) read once (a repeated row is served from L2), the new
    rows read in their own dtype, the window [0, pos] of every row
    written."""
    return bytes_bound_ms(2 * hd * (isz * (n_src * pos + bk * (pos + 1)) + row_isz * bk))


def phase_permute_append(torch, fused_step) -> dict:
    """K2 against its plain version, bitwise, at the beam main path's shape
    (large-v3 beam 5 batch 4: planes [2, 32, 20, 68, 1280], in fp8 and
    bf16, at pos 4, 35 and 67, both parities) and at a tiny f32 and a dev
    fp8 shape, each with new rows in f32, in bf16 (as the engine passes
    them) and as a strided bf16 view: the kernel converts them itself. The
    record is the fp8 case at pos 35 (about the mean position of a 64-token
    decode after a 4-token prompt), timed with bf16 rows, with f32 rows and
    with rows already in fp8 beside it; each of its calls must be one
    kernel in a profiler trace."""
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
        rows = _k2_rows(torch, gen, bk, hd)
        err = 0.0
        for rname, new in rows.items():
            for parity in (0, 1):
                ck, cv = (p.clone() for p in planes)
                rk, rv = (p.clone() for p in planes)
                fused_step.permute_append(ck, cv, idx, layer, pos, parity, *new)
                fused_step.permute_append_reference(rk, rv, idx, layer, pos, parity, *new)
                torch.cuda.synchronize()
                for a, b in ((ck, rk), (cv, rv)):
                    if not _k2_contract_equal(torch, a, b, layer, pos, parity):
                        fail(f"K2 differs from its plain version at {list(shape)} {dname} pos {pos} "
                             f"parity {parity}, {rname} rows")
                    w = 1 - parity
                    err = max(err, (a[w, layer, :, : pos + 1].float() - b[w, layer, :, : pos + 1].float())
                              .abs().max().item())
        isz = planes[0].element_size()
        n_src = int(torch.unique(idx).numel())
        new = rows["bf16"]
        bound = k2_bound_ms(hd, isz, 2, n_src, bk, pos)
        kern_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *new))
        log(
            f"  K2 {list(shape)} {dname} pos {pos}: bitwise equal (both parities; f32, bf16 and "
            f"strided bf16 rows); kernel with bf16 rows {kern_ms:.4f} ms, bound {bound:.4f} ms "
            f"(bytes; {n_src} distinct of {bk} source rows)"
        )
        if record is None and pos == 35:
            f32_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *rows["f32"]))
            stored = [n.to(dt) for n in new]
            stored_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *stored))
            plain_ms = time_ms(
                lambda: fused_step.permute_append_reference(ck, cv, idx, layer, pos, 0, *new)
            )
            idx_l = idx.long()
            srcs = [_as_bytes(p)[0, layer, :, :pos] for p in (ck, cv)]
            dsts = [torch.empty_like(s, memory_format=torch.contiguous_format) for s in srcs]

            def library():
                for s_, d_ in zip(srcs, dsts):
                    torch.index_select(s_, 0, idx_l, out=d_)

            lib_ms = time_ms(library)
            floor_ms = time_ms(lambda: torch.cuda._sleep(0))
            host_ms = host_ms_per_call(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *new))
            per_call = {r: kernels_per_call(torch, lambda: fused_step.permute_append(
                ck, cv, idx, layer, pos, 0, *rows[r])) for r in ("bf16", "f32")}
            for r, names in per_call.items():
                if len(names) != 1 or fused_step.KERNEL_SYMBOL not in names[0]:
                    fail(f"K2 with {r} rows launched {names}, expected its one kernel")
            # The same call on a permutation without duplicates: every
            # source row read from memory.
            perm = torch.randperm(bk, generator=gen, device="cuda").to(torch.int32)
            perm_ms = time_ms(lambda: fused_step.permute_append(ck, cv, perm, layer, pos, 0, *new))
            perm_bound = k2_bound_ms(hd, isz, 2, bk, bk, pos)
            log(
                f"    with f32 rows {f32_ms:.4f} ms, with rows already in fp8 {stored_ms:.4f} ms; "
                f"one kernel per call (bf16 and f32 rows); the "
                f"launch floor (torch.cuda._sleep(0)) {floor_ms:.4f} ms; the wrapper's host time "
                f"per call {host_ms:.4f} ms; plain {plain_ms:.4f} ms, index_select of the window "
                f"(gather only, no append) {lib_ms:.4f} ms; on a permutation without duplicates: "
                f"kernel {perm_ms:.4f} ms, bound {perm_bound:.4f} ms"
            )
            record = {
                "name": "permute_append", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/permute_append.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:628",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms, "shape": list(shape), "dtype": FP8, "pos": pos,
                "rows": "bfloat16", "f32_rows_ms": f32_ms, "fp8_rows_ms": stored_ms,
                "launch_floor_ms": floor_ms, "host_ms": host_ms,
                "kernels_per_call": len(per_call["bf16"]),
                "distinct_sources": n_src, "permutation_ms": perm_ms,
                "permutation_bound_ms": perm_bound,
            }
    return record


SWEEP_SHAPE = (2, 32, 20, 448, 1280)  # large-v3 beam 5 batch 4, the full 448-token text context
SWEEP_POS = (35, 100, 200, 440)


def k2_sweep(torch, fused_step) -> dict:
    """K2 over the flagship's whole text context: planes [2, 32, 20, 448,
    1280], pos 35, 100, 200 and 440, on an ``idx`` with duplicates and on a
    permutation; fp8 planes with new rows in bf16 (as the flagship passes
    them) and already in fp8, then bf16 planes with bf16 rows (the default
    config's cache: the copy alone). Each point is first checked bitwise
    against the plain version; each timed window cycles through the 32
    layers, as a decode step does, so the planes come from memory and not
    from L2. Works with any tree's ``ops/fused_step`` of the same signature
    (``--sweep-tree``). Returns the wrapper's host time per call and the
    timed points."""
    import itertools

    gen = torch.Generator(device="cuda").manual_seed(6)
    fp8 = getattr(torch, FP8)
    _, n_layer, bk, ctx, hd = SWEEP_SHAPE
    bf16 = [torch.randn((bk, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2)]
    dup = torch.randint(0, bk, (bk,), generator=gen, device="cuda", dtype=torch.int32)
    dup[1] = dup[0]
    perm = torch.randperm(bk, generator=gen, device="cuda").to(torch.int32)
    host_ms, out = None, []
    for pname, dt, rows in (("fp8", fp8, {"bf16": bf16, "fp8": [r.to(fp8) for r in bf16]}),
                            ("bf16", torch.bfloat16, {"bf16": bf16})):
        ck, cv = (torch.randint(0, 256, SWEEP_SHAPE, generator=gen, device="cuda", dtype=torch.uint8)
                  .view(fp8).to(dt) for _ in range(2))
        if host_ms is None:
            host_ms = host_ms_per_call(lambda: fused_step.permute_append(ck, cv, dup, 3, SWEEP_POS[0], 0, *bf16))
            log(f"  K2 sweep: the wrapper's host time per call (bf16 rows, pos {SWEEP_POS[0]}) {host_ms:.4f} ms")
        for pos in SWEEP_POS:
            for iname, idx in (("duplicates", dup), ("permutation", perm)):
                n_src = int(torch.unique(idx).numel())
                rk, rv = ck.clone(), cv.clone()
                fused_step.permute_append(ck, cv, idx, 3, pos, 0, *bf16)
                fused_step.permute_append_reference(rk, rv, idx, 3, pos, 0, *bf16)
                torch.cuda.synchronize()
                if not all(_k2_contract_equal(torch, a, b, 3, pos, 0) for a, b in ((ck, rk), (cv, rv))):
                    fail(f"K2 differs from its plain version at ctx {ctx}, {pname} planes, pos {pos}, {iname}")
                del rk, rv
                for rname, new in rows.items():
                    layers = itertools.cycle(range(n_layer))
                    ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, next(layers), pos, 0, *new))
                    bound = k2_bound_ms(hd, ck.element_size(), new[0].element_size(), n_src, bk, pos)
                    out.append({"planes": pname, "pos": pos, "idx": iname, "distinct_sources": n_src,
                                "rows": rname, "ms": ms, "bound_ms": bound})
                    log(f"  K2 sweep {list(SWEEP_SHAPE)} {pname} pos {pos} {iname} ({n_src} distinct), "
                        f"{rname} rows: {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.0%})")
        del ck, cv
    return {"host_ms": host_ms, "points": out}


def k3_bound_ms(hd, isz, row_isz, n_src, bk, pos, q_isz, q_dt) -> float:
    """Least time of one K3 call: K2's bytes (:func:`k2_bound_ms`) plus q
    read and attn written, or 4·BK·pos·HD operations (scores and values)
    at the query dtype's peak rate, whichever is larger (the bytes, at
    every shape this script times)."""
    import torch

    peak = PEAK_BF16_FLOPS if q_dt == torch.bfloat16 else PEAK_F32_FLOPS
    by_ops = 4.0 * bk * pos * hd / peak * 1e3
    by_bytes = k2_bound_ms(hd, isz, row_isz, n_src, bk, pos) + bytes_bound_ms(2 * bk * hd * q_isz)
    return max(by_ops, by_bytes)


def k3_sweep(torch, gather_attend, fused_step) -> dict:
    """K3 over the flagship's whole text context, beside K2 at the same
    points: planes [2, 32, 20, 448, 1280] fp8, a bf16 query, bf16 rows (as
    utils/probe_fused.py passes them), pos 35, 100, 200 and 440, on an
    ``idx`` with duplicates and on a permutation. Each point is first
    checked against the plain version (the write plane's window, the read
    plane and the other layers bitwise; attn within 4 bf16 ulps); each
    timed window cycles through the 32 layers, as a decode step does.
    Works with any tree's ``ops/gather_attend`` of the same signature
    (``--sweep-tree``)."""
    import itertools

    gen = torch.Generator(device="cuda").manual_seed(7)
    fp8 = getattr(torch, FP8)
    _, n_layer, bk, ctx, hd = SWEEP_SHAPE
    n_head = 20
    rows = [torch.randn((bk, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2)]
    q = torch.randn((bk, hd), generator=gen, device="cuda").to(torch.bfloat16)
    dup = torch.randint(0, bk, (bk,), generator=gen, device="cuda", dtype=torch.int32)
    dup[1] = dup[0]
    perm = torch.randperm(bk, generator=gen, device="cuda").to(torch.int32)
    ck, cv = ((4 * torch.randn(SWEEP_SHAPE, generator=gen, device="cuda")).to(fp8) for _ in range(2))
    host_ms = host_ms_per_call(lambda: gather_attend.fused_gather_attend(
        ck, cv, dup, 3, SWEEP_POS[0], 0, q, *rows, n_head=n_head))
    log(f"  K3 sweep: the wrapper's host time per call (bf16 rows, pos {SWEEP_POS[0]}) {host_ms:.4f} ms")
    out = []
    for pos in SWEEP_POS:
        for iname, idx in (("duplicates", dup), ("permutation", perm)):
            n_src = int(torch.unique(idx).numel())
            rk, rv = ck.clone(), cv.clone()
            got, _, _ = gather_attend.fused_gather_attend(ck, cv, idx, 3, pos, 0, q, *rows, n_head=n_head)
            ref, _, _ = gather_attend.fused_gather_attend_reference(rk, rv, idx, 3, pos, 0, q, *rows, n_head=n_head)
            torch.cuda.synchronize()
            if not all(_k2_contract_equal(torch, a, b, 3, pos, 0) for a, b in ((ck, rk), (cv, rv))):
                fail(f"K3 planes differ from its plain version at ctx {ctx}, pos {pos}, {iname}")
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= bf16_tolerance(ref.float().abs().max().item()):
                fail(f"K3 attn differs from its plain version at ctx {ctx}, pos {pos}, {iname}: {err}")
            del rk, rv
            layers = itertools.cycle(range(n_layer))
            ms = time_ms(lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, next(layers), pos, 0, q, *rows, n_head=n_head))
            k2_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, next(layers), pos, 0, *rows))
            bound = k3_bound_ms(hd, 1, 2, n_src, bk, pos, 2, torch.bfloat16)
            out.append({"pos": pos, "idx": iname, "distinct_sources": n_src, "ms": ms, "k2_ms": k2_ms,
                        "bound_ms": bound, "max_abs_err": err})
            log(f"  K3 sweep {list(SWEEP_SHAPE)} fp8 pos {pos} {iname} ({n_src} distinct), bf16 rows: "
                f"{ms:.4f} ms, K2 {k2_ms:.4f} ms (K3 - K2 {ms - k2_ms:.4f}), bound {bound:.4f} ms "
                f"({bound / ms:.0%}); attn max_abs_err {err:.3g}")
    del ck, cv
    return {"host_ms": host_ms, "points": out}


def phase_permute_append_sharded(torch, fused_step) -> dict:
    """K2′ against its plain version, bitwise, on one rank's planes of the
    data-parallel beam path (large-v3 beam 5, a batch of 4 on 2 ranks:
    planes [2, 32, 10, 68, 1280]) with rank 1's global source rows (10..19,
    each within its sample, a duplicate always), fp8 at pos 35 (the record)
    and bf16 at pos 67, both parities, plus a tiny f32 shape, each with new
    rows in f32, in bf16 and as a strided bf16 view. K2's count must not
    move. The record is timed with bf16 rows (f32 beside), beside its bound,
    the plain version and ``index_select`` of the localised K and V
    windows, and must be one kernel per call."""
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
        rows = _k2_rows(torch, gen, bk, hd)
        err = 0.0
        k2_before = fused_step.launches
        for rname, new in rows.items():
            for parity in (0, 1):
                ck, cv = (p.clone() for p in planes)
                rk, rv = (p.clone() for p in planes)
                fused_step.permute_append_sharded(ck, cv, idx, layer, pos, parity, *new, beam=beam)
                fused_step.permute_append_sharded_reference(rk, rv, idx, layer, pos, parity, *new, beam=beam)
                torch.cuda.synchronize()
                for a, b in ((ck, rk), (cv, rv)):
                    if not _k2_contract_equal(torch, a, b, layer, pos, parity):
                        fail(f"K2′ differs from its plain version at {list(shape)} {dt} pos {pos} "
                             f"parity {parity}, {rname} rows")
                    w = 1 - parity
                    err = max(err, (a[w, layer, :, : pos + 1].float() - b[w, layer, :, : pos + 1].float())
                              .abs().max().item())
        if fused_step.launches != k2_before:
            fail("K2′ launched K2")
        local = fused_step.localize(idx, beam)
        isz = planes[0].element_size()
        n_src = int(torch.unique(local).numel())
        new = rows["bf16"]
        bound = k2_bound_ms(hd, isz, 2, n_src, bk, pos)
        kern_ms = time_ms(lambda: fused_step.permute_append_sharded(
            ck, cv, idx, layer, pos, 0, *new, beam=beam))
        log(
            f"  K2′ {list(shape)} {str(dt)[6:]} pos {pos}, global rows {bk}..{2 * bk - 1}: bitwise "
            f"equal (both parities; f32, bf16 and strided bf16 rows); kernel with bf16 rows "
            f"{kern_ms:.4f} ms, bound {bound:.4f} ms (bytes; {n_src} distinct of {bk} source rows)"
        )
        if record is None:
            f32_ms = time_ms(lambda: fused_step.permute_append_sharded(
                ck, cv, idx, layer, pos, 0, *rows["f32"], beam=beam))
            plain_ms = time_ms(lambda: fused_step.permute_append_sharded_reference(
                ck, cv, idx, layer, pos, 0, *new, beam=beam))
            host_ms = host_ms_per_call(lambda: fused_step.permute_append_sharded(
                ck, cv, idx, layer, pos, 0, *new, beam=beam))
            names = kernels_per_call(torch, lambda: fused_step.permute_append_sharded(
                ck, cv, idx, layer, pos, 0, *new, beam=beam))
            if len(names) != 1 or fused_step.SHARDED_KERNEL_SYMBOL not in names[0]:
                fail(f"K2′ with bf16 rows launched {names}, expected its one kernel")
            srcs = [_as_bytes(p)[0, layer, :, :pos] for p in (ck, cv)]
            dsts = [torch.empty_like(s, memory_format=torch.contiguous_format) for s in srcs]

            def library():  # index_select of the localised windows: the gather only
                for s_, d_ in zip(srcs, dsts):
                    torch.index_select(s_, 0, local, out=d_)

            lib_ms = time_ms(library)
            local32 = local.int()
            k2_ms = time_ms(lambda: fused_step.permute_append(ck, cv, local32, layer, pos, 0, *new))
            log(f"    with f32 rows {f32_ms:.4f} ms; one kernel per call; the wrapper's host time per "
                f"call {host_ms:.4f} ms; plain {plain_ms:.4f} ms, index_select of the localised windows "
                f"(gather only, no append) {lib_ms:.4f} ms; K2 on the same rows numbered locally "
                f"{k2_ms:.4f} ms")
            record = {
                "name": "permute_append_sharded", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/permute_append.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:737",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms, "library_call": "index_select x2 of the localised windows",
                "shape": list(shape), "dtype": FP8, "pos": pos, "global_rows": [bk, 2 * bk - 1],
                "rows": "bfloat16", "f32_rows_ms": f32_ms, "host_ms": host_ms,
                "kernels_per_call": len(names), "distinct_sources": n_src, "k2_local_ms": k2_ms,
            }
    return record


def _fp8_midpoints(torch, dtype):
    """Midpoints of adjacent finite values of an fp8 format, and the f32
    values one ulp either side of each."""
    vals = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype).float()
    vals = torch.unique(vals[torch.isfinite(vals)])
    mid = (vals[1:] + vals[:-1]) / 2
    return torch.cat([mid, torch.nextafter(mid, mid + 1), torch.nextafter(mid, mid - 1)])


def phase_store_cast(torch, fused_step) -> int:
    """The conversion inside K2 (``csrc/store_cast.cuh``) against PyTorch's
    ``.to()`` on the card, BITWISE: every one of the 65,536 bf16 and f16
    bit patterns, and f32 at the edges (±0, ±inf, ±NaN, ±448, ±464, ±480,
    2⁻¹⁰, 1.5·2⁻⁹, −1e-9, e5m2's overflow, subnormals, the midpoints of
    adjacent e4m3 and e5m2 values and one ulp either side), into each
    storage dtype (f32, bf16, f16, e4m3, e5m2). Returns the cases checked."""
    storage = [torch.float32, torch.bfloat16, torch.float16, getattr(torch, FP8), torch.float8_e5m2]
    patterns = torch.arange(-(2**15), 2**15, dtype=torch.int32, device="cuda").to(torch.int16)
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), -float("nan"),
                          448.0, -448.0, 464.0, -464.0, 480.0, -480.0, 2.0**-10, 1.5 * 2.0**-9,
                          -1e-9, 57344.0, 61440.0, -65536.0, 2.0**-17, 1e-40, -1e-40, 3e38])
    f32 = torch.cat([edges, _fp8_midpoints(torch, storage[3]), _fp8_midpoints(torch, storage[4])])
    f32 = torch.cat([f32, torch.zeros(-f32.numel() % 64)]).view(-1, 64).cuda()
    sources = {"bf16 patterns": patterns.view(torch.bfloat16).view(64, 1024),
               "f16 patterns": patterns.view(torch.float16).view(64, 1024), "f32 edges": f32}
    n = 0
    for sname, rows in sources.items():
        bk, hd = rows.shape
        idx = torch.arange(bk, dtype=torch.int32, device="cuda")
        for dt in storage:
            planes = [torch.zeros((2, 1, bk, 2, hd), device="cuda").to(dt) for _ in range(2)]
            fused_step.permute_append(*planes, idx, 0, 1, 0, rows, rows)
            want = _as_bytes(rows.to(dt))
            for p in planes:
                got = _as_bytes(p[1, 0, :, 1])
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    fail(f"K2's conversion of {sname} into {dt} differs from .to() in {bad} bytes")
            n += 1
    log(f"  K2's in-kernel conversion: bitwise equal to .to() in all {n} cases (every bf16 and f16 "
        f"pattern, {f32.numel()} f32 edge values, into f32, bf16, f16, e4m3 and e5m2)")
    return n


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
        bf16_rows = [n.to(torch.bfloat16) for n in new]  # as utils/probe_fused.py passes them
        err = 0.0
        for parity, rows in ((0, new), (1, new), (0, bf16_rows), (1, bf16_rows)):
            ck, cv = (p.clone() for p in planes)
            rk, rv = (p.clone() for p in planes)
            ok_, ov_ = (p.clone() for p in planes)
            out, _, _ = gather_attend.fused_gather_attend(ck, cv, idx, layer, pos, parity, q, *rows, n_head=n_head)
            ref, _, _ = gather_attend.fused_gather_attend_reference(
                rk, rv, idx, layer, pos, parity, q, *rows, n_head=n_head)
            orc, _, _ = gather_attend.reference_gather_attend(
                ok_, ov_, idx, layer, pos, parity, q, *rows, n_head=n_head)
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
        # Bytes this run's data needs moved, and operations: k3_bound_ms.
        # Timed with bf16 rows, as utils/probe_fused.py passes them (the
        # kernel casts them); f32 rows and rows already in the storage dtype
        # are timed beside the record.
        isz = planes[0].element_size()
        n_src = int(torch.unique(idx).numel())
        bound = k3_bound_ms(hd, isz, 2, n_src, bk, pos, q.element_size(), q_dt)
        kern_ms = time_ms(lambda: gather_attend.fused_gather_attend(
            ck, cv, idx, layer, pos, 0, q, *bf16_rows, n_head=n_head))
        log(
            f"  K3 {list(shape)} {dname} pos {pos}: planes bitwise equal, attn max_abs_err {err:.3g} "
            f"(both parities; f32 and bf16 rows; within {oracle_tol[dname]} of reference_gather_attend); "
            f"kernel with bf16 rows {kern_ms:.4f} ms, bound {bound:.4f} ms (bytes; {n_src} distinct of "
            f"{bk} source rows)"
        )
        if dname == "fp8" and pos == 4:
            floor_ms = kern_ms  # the record's shape at pos 4: the kernel's chain of dependent steps
        if record is None and pos == 35:
            stored = [n.to(dt) for n in new]
            f32_ms = time_ms(lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, layer, pos, 0, q, *new, n_head=n_head))
            stored_ms = time_ms(lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, layer, pos, 0, q, *stored, n_head=n_head))
            host_ms = host_ms_per_call(lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, layer, pos, 0, q, *bf16_rows, n_head=n_head))
            per_call = {r: kernels_per_call(torch, lambda: gather_attend.fused_gather_attend(
                ck, cv, idx, layer, pos, 0, q, *rows_, n_head=n_head))
                for r, rows_ in (("bf16", bf16_rows), ("f32", new))}
            for r, names in per_call.items():
                if len(names) != 1 or gather_attend.KERNEL_SYMBOL not in names[0]:
                    fail(f"K3 with {r} rows launched {names}, expected its one kernel")
            k2_ms = time_ms(lambda: fused_step.permute_append(ck, cv, idx, layer, pos, 0, *bf16_rows))
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
                ck, cv, perm, layer, pos, 0, q, *bf16_rows, n_head=n_head))
            perm_bound = k3_bound_ms(hd, isz, 2, bk, bk, pos, q.element_size(), q_dt)
            log(
                f"    with f32 rows {f32_ms:.4f} ms, with rows already in fp8 {stored_ms:.4f} ms; one "
                f"kernel per call (bf16 and f32 rows); at pos 4 {floor_ms:.4f} ms; the wrapper's host "
                f"time per call {host_ms:.4f} ms; K2 on the same call {k2_ms:.4f} ms; plain "
                f"{plain_ms:.4f} ms; hybrid composite (K2 + qkv_attention) {hybrid_ms:.4f} ms; "
                f"index_select ×2 + upcast ×2 + scaled_dot_product_attention (window [0, pos) only, no "
                f"append) {lib_ms:.4f} ms; on a permutation without duplicates: kernel {perm_ms:.4f} ms, "
                f"bound {perm_bound:.4f} ms"
            )
            record = {
                "name": "gather_attend", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/gather_attend.cu",
                "replaces": "whisper_tpu/ops/fused_step.py:328",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib_ms,
                "library_call": "index_select x2 + .to(bfloat16) x2 + scaled_dot_product_attention",
                "hybrid_ms": hybrid_ms, "rows": "bfloat16", "f32_rows_ms": f32_ms,
                "fp8_rows_ms": stored_ms, "pos4_ms": floor_ms, "host_ms": host_ms,
                "kernels_per_call": len(per_call["bf16"]), "k2_ms": k2_ms,
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
            kernel_gflop = b * 3000 * mel_fused.kernel_flops(n_mels) / 1e9
            host_ms = host_ms_per_call(lambda: mel_fused.log10_mel_kernel(x, n_mels))
            log(f"    kernel {kern_ms:.4f} ms, with the torch epilogue {wrap_ms:.4f} ms; bound "
                f"{bound['ms']:.4f} ms ({bound['by']}; rFFT + filterbank non-zeros {bound['gflop']:.3f} "
                f"GFLOP; {bound['ms'] / kern_ms:.1%}); the kernel's own operations (20 × 20 real DFT, "
                f"sparse mel) {kernel_gflop:.3f} GFLOP, {kernel_gflop / kern_ms:.1f} TFLOP/s; the "
                f"wrapper's host time per call {host_ms:.4f} ms; plain {plain_ms:.4f} ms; torch.stft + mel matmul + log10 (cuFFT, cuBLAS, several calls; "
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
                "kernel_gflop": kernel_gflop, "kernel_tflops": kernel_gflop / kern_ms, "host_ms": host_ms,
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


def phase_main_path(torch, kernels, EngineConfig, EngineType, create_engine) -> tuple:
    """Greedy main path (docstring, phase 4). Returns K1's launches, the
    engine and its batch's results."""
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
    return launches, engine, results


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


SERVING_TIMEOUT_S = 600  # per future: a hang fails the run, it does not stall it


def int16_exact(x: np.ndarray) -> np.ndarray:
    """``x`` on the int16 grid, as a WAV file's samples are: the engine
    ships audio as int16 and the slot pool's prefill takes float32, and on
    such samples the two see the same audio."""
    return (np.round(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0).astype(np.float32)


def _serve_all(transcriber, utts) -> list:
    with transcriber as t:
        futures = [t.submit(u) for u in utts]
        return [f.result(timeout=SERVING_TIMEOUT_S) for f in futures]


def _same_tokens(a, b) -> bool:
    return a.length == b.length and np.array_equal(a.tokens[: a.length], b.tokens[: b.length])


def phase_serving_card_vs_cpu(torch, params, cfg, Monolith) -> None:
    """Phase 5's serving part (docstring): the serving classes on the card
    against ``engine.transcribe`` on the card and against themselves on the
    CPU, at ``tiny`` f32 (TF32 already off)."""
    from whisper_tpu_torch.engine.serving import (
        AsyncTranscriber,
        ContinuousTranscriber,
        DisaggregatedTranscriber,
    )

    cfg = dataclasses.replace(cfg, audio_ctx=None)
    utts = [int16_exact(synthetic_utterance(s, 40 + i)) for i, s in enumerate((3.0, 7.5, 12.0, 21.0, 30.0))]
    classes = {
        "ContinuousTranscriber": lambda e: ContinuousTranscriber(e, n_slots=2, prefill_batch=2),
        "DisaggregatedTranscriber": lambda e: DisaggregatedTranscriber(e, n_slots=2, prefill_batch=2),
        "AsyncTranscriber": lambda e: AsyncTranscriber(e, max_batch=2),
    }
    runs = {}
    for device in ("cuda", "cpu"):
        engine = Monolith.from_assets(params, cfg, device=device)
        runs[device, "engine.transcribe"] = [engine.transcribe(u) for u in utts]
        for name, make in classes.items():
            runs[device, name] = _serve_all(make(engine), utts)
    ref = runs["cuda", "engine.transcribe"]
    for r in ref:
        log(f"  serving, card engine.transcribe: {r.tokens[: r.length].tolist()}")
    for name in classes:
        card, cpu = runs["cuda", name], runs["cpu", name]
        if not all(_same_tokens(a, b) and a.language == b.language for a, b in zip(card, ref)):
            fail(f"tiny f32 serving: {name} on the card differs from engine.transcribe on the card")
        if not all(_same_tokens(a, b) for a, b in zip(card, cpu)):
            fail(f"tiny f32 serving: {name} differs between card and CPU")
        log(f"  serving, {name} ({len(utts)} utterances): card == engine.transcribe == CPU")
    fp8 = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    card, cpu = (
        _serve_all(ContinuousTranscriber(Monolith.from_assets(params, fp8, device=d), n_slots=2, prefill_batch=2), utts)
        for d in ("cuda", "cpu")
    )
    if not all(_same_tokens(a, b) for a, b in zip(card, cpu)):
        fail("tiny f32 serving: ContinuousTranscriber with the fp8 KV cache differs between card and CPU")
    log(f"  serving, ContinuousTranscriber with the fp8 KV cache: card == CPU "
        f"({sum(a.length for a in card)} tokens)")


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

    phase_options_card_vs_cpu(params, cfg, x, Monolith)
    phase_serving_card_vs_cpu(torch, params, cfg, Monolith)


def phase_options_card_vs_cpu(params, cfg, x, Monolith) -> None:
    """Phase 5's part for the options of PR 9 (docstring): the sampling path
    at T = 0, word timestamps and ``transcribe_sequential``, card == CPU."""
    runs = {}
    ladder = dataclasses.replace(cfg, fallback_temperatures=(0.5,), logprob_threshold=None,
                                 compression_ratio_threshold=None)
    words = dataclasses.replace(cfg, word_timestamps=True)
    vocab = word_vocab(Monolith.from_assets(params, cfg, device="cpu").vocab, cfg.dims().n_vocab)
    y = synthetic_utterance(35.0, 7)
    for device in ("cuda", "cpu"):
        runs[device, "plain"] = Monolith.from_assets(params, cfg, device=device).transcribe_batch(x)
        runs[device, "ladder"] = Monolith.from_assets(params, ladder, device=device).transcribe_batch(x)
        runs[device, "words"] = Monolith.from_assets(params, words, vocab=vocab, device=device).transcribe_batch(x)
        runs[device, "sequential"] = [Monolith.from_assets(params, cfg, device=device).transcribe_sequential(y)]
    for a, b, p in zip(runs["cuda", "ladder"], runs["cpu", "ladder"], runs["cuda", "plain"]):
        if not (_same_tokens(a, b) and _same_tokens(a, p)) or (a.temperature, b.temperature) != (0.0, 0.0):
            fail("tiny f32: the sampling path at T = 0 differs between card, CPU and the argmax path")
    log("  sampling path at T = 0: card == CPU == the argmax path's tokens")
    for a, b in zip(runs["cuda", "words"], runs["cpu", "words"]):
        wa, wb = ([(w.word, w.start, w.end) for w in r.words] for r in (a, b))
        log(f"  words, card: {len(wa)}, first {wa[:4]}")
        if not _same_tokens(a, b) or wa != wb:
            fail(f"tiny f32 word timestamps: card {wa} differ from the CPU's {wb}")
    log("  word timestamps: card == CPU")
    (a,), (b,) = runs["cuda", "sequential"], runs["cpu", "sequential"]
    segs = [(s.start, s.end) for s in a.segments]
    log(f"  transcribe_sequential 35 s: {a.length} tokens, segments {segs}")
    if a.tokens.tolist() != b.tokens.tolist() or segs != [(s.start, s.end) for s in b.segments]:
        fail("tiny f32 transcribe_sequential: card tokens or segments differ from the CPU's")
    log("  transcribe_sequential: card == CPU")


SERVING_LENGTHS_S = (2.0, 4.5, 7.0, 9.5, 12.0, 14.5, 17.0, 19.5, 22.0, 24.5, 27.0, 30.0)


def serving_utterances() -> list:
    return [int16_exact(synthetic_utterance(s, 20 + i)) for i, s in enumerate(SERVING_LENGTHS_S)]


def _drive(transcriber, utts, waves) -> tuple:
    """Submit ``utts`` in ``waves`` (lists of indices); before each later
    wave, wait on the first result of the one before. Returns (results,
    per-request latencies in s, submit → result, wall s). Call it inside
    the transcriber's ``with``: the latencies are complete once it closed."""
    lat = [None] * len(utts)
    futures = [None] * len(utts)
    t_start = time.perf_counter()
    for w, wave in enumerate(waves):
        if w:
            futures[waves[w - 1][0]].result(timeout=SERVING_TIMEOUT_S)
        for i in wave:
            t0 = time.perf_counter()
            futures[i] = transcriber.submit(utts[i])
            futures[i].add_done_callback(lambda _f, i=i, t0=t0: lat.__setitem__(i, time.perf_counter() - t0))
    results = [f.result(timeout=SERVING_TIMEOUT_S) for f in futures]
    return results, lat, time.perf_counter() - t_start


def _latency_line(lat, audio_s, wall) -> tuple:
    p50, p95 = (float(np.percentile(lat, q)) for q in (50, 95))
    return p50, p95, f"latency p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms; {audio_s / wall:.2f} audio-s/s"


def phase_slot_pool(torch, kernels, engine, utts, cls) -> dict:
    """Phase 6a for one slot-pool class: the 12 utterances in three waves,
    launches counted over the run."""
    attention, fused_step, gather, gather_attend, mel_fused = kernels
    pool = cls(engine, n_slots=8, prefill_batch=2)
    pool.warmup()
    reset_counts(*kernels)  # counts start here: the slot pool's run
    with pool:
        results, lat, wall = _drive(pool, utts, [list(range(i, i + 4)) for i in (0, 4, 8)])
    torch.cuda.synchronize()
    k1 = attention.launches
    others = (fused_step.launches, fused_step.sharded_launches, gather_attend.launches, gather.launches,
              mel_fused.launches)  # counts end here
    check_results(results, engine, engine.dims.n_vocab)
    audio_s = sum(len(u) for u in utts) / 16_000.0
    p50, p95, line = _latency_line(lat, audio_s, wall)
    prefills, steps = pool._prefill_dispatches, pool._step_dispatches
    log(f"  {cls.__name__}: {len(utts)} utterances ({audio_s:.1f} s of audio) in {wall * 1e3:.1f} ms; {line}; "
        f"occupancy {pool.occupancy:.3f}, dispatch efficiency {pool.dispatch_efficiency:.3f}, "
        f"{steps} macro-steps of {pool.sync_every} steps, {prefills} prefill dispatches")
    log(f"    launches: K1 {k1} ({prefills} prefills × {LARGE_V3_ENC_LAYERS} layers); K2, K2′, K3, K4, K5 {others}")
    if k1 != LARGE_V3_ENC_LAYERS * prefills or prefills == 0:
        fail(f"{cls.__name__}: K1 launched {k1} times, expected {LARGE_V3_ENC_LAYERS} × {prefills} prefills")
    if any(others):
        fail(f"{cls.__name__}: K2, K2′, K3, K4, K5 launched {others} times, expected none")
    return {"class": cls.__name__, "results": results, "k1": k1, "prefill_dispatches": prefills,
            "macro_steps": steps, "latency_p50_s": p50, "latency_p95_s": p95, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "occupancy": pool.occupancy,
            "dispatch_efficiency": pool.dispatch_efficiency}


def phase_serving(torch, kernels, EngineConfig, EngineType, create_engine) -> tuple:
    """Phase 6a (docstring). Returns the engine and each class's record."""
    from whisper_tpu_torch.engine.serving import ContinuousTranscriber, DisaggregatedTranscriber

    cfg = EngineConfig(model="large-v3", max_new_tokens=64, audio_ctx=None)
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")  # phase 4's weights
    utts = serving_utterances()
    records = [phase_slot_pool(torch, kernels, engine, utts, cls)
               for cls in (ContinuousTranscriber, DisaggregatedTranscriber)]
    single = [engine.transcribe(u) for u in utts]
    for rec in records:
        agree = sum(_same_tokens(a, b) for a, b in zip(rec.pop("results"), single))
        log(f"  information: {rec['class']}: {agree} of {len(utts)} utterances token-equal to "
            f"engine.transcribe (bf16 at other batch shapes may flip near ties)")
        rec["agree_with_transcribe"] = agree
    return engine, records


def phase_async_flagship(torch, kernels, beam, engine) -> dict:
    """Phase 6b (docstring): 8 utterances from 4 threads through
    ``AsyncTranscriber(max_batch=4)`` over the flagship engine."""
    import threading

    from whisper_tpu_torch.engine.serving import AsyncTranscriber

    attention, fused_step, gather, gather_attend, mel_fused = kernels
    utts = serving_utterances()[2:10]
    lat = [None] * len(utts)
    results = [None] * len(utts)

    def client(t, lo):
        for i in (lo, lo + 4):
            t0 = time.perf_counter()
            results[i] = t.submit(utts[i]).result(timeout=SERVING_TIMEOUT_S)
            lat[i] = time.perf_counter() - t0

    def batches_run():  # transcribe_batch calls: the engine times each as "model"
        stats = engine.timer.summary().get("model")
        return stats.count if stats else 0

    flushes0 = batches_run()
    reset_counts(*kernels)  # counts start here: the micro-batcher's run
    beam.steps = 0
    t_start = time.perf_counter()
    with AsyncTranscriber(engine, max_batch=4, max_wait_ms=20) as t:
        threads = [threading.Thread(target=client, args=(t, c)) for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * SERVING_TIMEOUT_S)
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    k1, k2, steps = attention.launches, fused_step.launches, beam.steps
    others = (gather.launches, gather_attend.launches, mel_fused.launches, fused_step.sharded_launches)
    # counts end here
    flushes = batches_run() - flushes0
    if any(th.is_alive() for th in threads) or any(r is None for r in results):
        fail("async flagship: a client thread did not finish")
    check_results(results, engine, engine.dims.n_vocab)
    audio_s = sum(len(u) for u in utts) / 16_000.0
    p50, p95, line = _latency_line(lat, audio_s, wall)
    log(f"  AsyncTranscriber(max_batch=4), flagship: {len(utts)} utterances from 4 threads "
        f"({audio_s:.1f} s of audio) in {wall * 1e3:.1f} ms; {line}; {flushes} flushes, {steps} beam steps")
    log(f"    launches: K1 {k1} ({flushes} flushes × {LARGE_V3_ENC_LAYERS}), K2 {k2} ({steps} steps × "
        f"{LARGE_V3_DEC_LAYERS}); K4, K3, K5, K2′ {others}")
    if flushes == 0 or k1 != LARGE_V3_ENC_LAYERS * flushes:
        fail(f"async flagship: K1 launched {k1} times over {flushes} flushes")
    if steps == 0 or k2 != LARGE_V3_DEC_LAYERS * steps:
        fail(f"async flagship: K2 launched {k2} times over {steps} beam steps")
    if any(others):
        fail(f"async flagship: K4, K3, K5, K2′ launched {others} times, expected none")
    return {"k1": k1, "k2": k2, "flushes": flushes, "beam_steps": steps, "latency_p50_s": p50,
            "latency_p95_s": p95, "wall_s": wall, "audio_s_per_s": audio_s / wall}


def phase_http(engine) -> None:
    """Phase 6c (docstring)."""
    import urllib.request

    from whisper_tpu_torch.audio.wav import read_wav_bytes, write_wav
    from whisper_tpu_torch.engine.http_server import TranscribeServer

    utts = serving_utterances()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost, never a proxy
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "utterance.wav")
        write_wav(path, utts[3])
        with open(path, "rb") as f:
            wav = f.read()
    bodies = [("WAV", wav, "audio/wav", read_wav_bytes(wav)),
              ("raw PCM", utts[6].astype("<f4").tobytes(), "application/octet-stream+pcm", utts[6])]
    with TranscribeServer(engine, mode="continuous") as server:
        base = f"http://{server.host}:{server.port}"
        for name, body, ctype, samples in bodies:
            req = urllib.request.Request(base + "/transcribe", data=body, headers={"Content-Type": ctype},
                                         method="POST")
            with opener.open(req, timeout=SERVING_TIMEOUT_S) as resp:
                status, out = resp.status, json.loads(resp.read())
            ref = server._transcriber.submit(samples).result(timeout=SERVING_TIMEOUT_S)
            log(f"  POST {name} ({len(body)} bytes): {status}, length {out['length']}, language "
                f"{out['language']}; the same pool's result: length {ref.length}")
            if status != 200 or out["text"] != ref.clean_text() or out["length"] != ref.length:
                fail(f"HTTP {name}: {status} {out} differs from the slot pool's result")
        with opener.open(base + "/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
    tp = metrics["throughput"]
    log(f"  /metrics: {metrics['requests']} requests, {metrics['errors']} errors, occupancy "
        f"{metrics['occupancy']:.3f}, engine throughput {tp['audio_seconds_per_s']:.2f} audio-s/s over "
        f"{tp['utterances']} utterances")
    if metrics["requests"] != 2 or metrics["errors"] != 0 or not tp["audio_seconds_per_s"] > 0:
        fail(f"/metrics: {metrics}")


class _Spy:
    """Records the calls of one engine method (``_run``: one encode each;
    ``_seq_window``: one sequential window each) while the ``with`` lasts."""

    def __init__(self, engine, name: str):
        self.engine, self.name, self.calls = engine, name, []

    def __enter__(self):
        inner = getattr(self.engine, self.name)

        def spy(*args, **kw):
            self.calls.append((args, kw))
            return inner(*args, **kw)

        setattr(self.engine, self.name, spy)
        return self

    def __exit__(self, *exc):
        delattr(self.engine, self.name)


def _counts(kernels, beam) -> dict:
    attention, fused_step, gather, gather_attend, mel_fused = kernels
    return {"K1": attention.launches, "K2": fused_step.launches, "K2′": fused_step.sharded_launches,
            "K3": gather_attend.launches, "K4": gather.launches, "K5": mel_fused.launches,
            "beam_steps": beam.steps}


def _expect(label: str, got: dict, want: dict) -> None:
    """Every kernel's launches as ``want`` says (0 where it says nothing)."""
    bad = {k: (got[k], want.get(k, 0)) for k in ("K1", "K2", "K2′", "K3", "K4", "K5")
           if got[k] != want.get(k, 0)}
    if bad:
        fail(f"{label}: launches (got, expected) {bad}")


def _engine_with(engine, **changes):
    """An engine over ``engine``'s weights (already on the card) with
    config ``changes``."""
    return type(engine)(engine.assets, dataclasses.replace(engine.config, **changes), device=engine.device)


def _timed(torch, kernels, beam, fn) -> tuple:
    """``fn()`` with every launch count set to 0 just before and read just
    after, on a synchronised host clock → (result, wall s, counts)."""
    torch.cuda.synchronize()
    reset_counts(*kernels)  # counts start here
    beam.steps = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, _counts(kernels, beam)  # counts end here


def phase_ladder(torch, kernels, beam, engine, label) -> dict:
    """Phases 7a and 7b (docstring): ``engine``'s config with the default
    ladder and gates on phase 4's batch. K1 once per layer of every
    encode (the primary and each retry sub-batch), K2 once per layer of
    every beam step (a beam primary's only: the retries sample)."""
    from whisper_tpu_torch.decode.fallback import DEFAULT_TEMPERATURES

    _, batch, audio_s = main_path_batch()
    eng = _engine_with(engine, fallback_temperatures=DEFAULT_TEMPERATURES[1:])
    with _Spy(eng, "_run") as spy:
        results, wall, n = _timed(torch, kernels, beam, lambda: eng.transcribe_batch(batch))
    check_results(results, eng, eng.dims.n_vocab)
    temps = [r.temperature for r in results]
    if any(t not in DEFAULT_TEMPERATURES for t in temps):
        fail(f"{label}: temperatures {temps} outside the schedule {DEFAULT_TEMPERATURES}")
    runs = [(args[0].shape[0], kw.get("temperature")) for args, kw in spy.calls]
    attempts = 1 + max(DEFAULT_TEMPERATURES.index(t) for t in temps)
    retried = [sum(DEFAULT_TEMPERATURES.index(t) >= k for t in temps) for k in range(1, attempts)]
    log(f"  {label}: {len(results)} utterances ({audio_s:.1f} s of audio) in {wall * 1e3:.1f} ms "
        f"→ {audio_s / wall:.2f} audio-s/s; temperatures {temps}")
    log(f"    runs (padded rows, temperature): {runs}; rows retried per attempt {retried}; "
        f"avg_logprob {[round(r.avg_logprob, 3) for r in results]}; compression ratio "
        f"{[round(r.compression_ratio, 3) for r in results]}")
    log(f"    launches: {n} ({len(runs)} encodes × {LARGE_V3_ENC_LAYERS}, {n['beam_steps']} beam steps × "
        f"{LARGE_V3_DEC_LAYERS})")
    if len(runs) != attempts or [t for _, t in runs[1:]] != list(DEFAULT_TEMPERATURES[1:attempts]):
        fail(f"{label}: runs {runs} do not match the kept temperatures {temps}")
    beam_primary = eng.config.beam_size > 1
    if beam_primary != (runs[0][1] is None) or (beam_primary and n["beam_steps"] == 0):
        fail(f"{label}: primary run {runs[0]} with {n['beam_steps']} beam steps")
    _expect(label, n, {"K1": LARGE_V3_ENC_LAYERS * len(runs), "K2": LARGE_V3_DEC_LAYERS * n["beam_steps"]})
    return {"audio_s_per_s": audio_s / wall, "wall_s": wall, "temperatures": temps, "runs": runs,
            "retried_per_attempt": retried, "launches": n}


def phase_ladder_gates_off(torch, kernels, beam, engine, phase4_results) -> dict:
    """Phase 7a's second run: the ladder with both gates off, so the
    primary runs through the sampler at T = 0: tokens equal phase 4's."""
    from whisper_tpu_torch.decode.fallback import DEFAULT_TEMPERATURES

    _, batch, audio_s = main_path_batch()
    eng = _engine_with(engine, fallback_temperatures=DEFAULT_TEMPERATURES[1:],
                       compression_ratio_threshold=None, logprob_threshold=None)
    results, wall, n = _timed(torch, kernels, beam, lambda: eng.transcribe_batch(batch))
    log(f"  7a, gates off: {wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; launches {n}")
    _expect("7a gates off", n, {"K1": LARGE_V3_ENC_LAYERS})
    for a, b in zip(results, phase4_results):
        if a.temperature != 0.0 or not _same_tokens(a, b):
            fail(f"7a gates off: T {a.temperature}, tokens {a.tokens[: a.length].tolist()} differ from "
                 f"phase 4's {b.tokens[: b.length].tolist()}")
    log("    tokens through the sampler at T = 0 equal phase 4's")
    return {"audio_s_per_s": audio_s / wall, "wall_s": wall, "launches": n}


def word_vocab(vocab, n_vocab: int):
    """``vocab`` with every id from 256 up to EOT surfaced as a word of its
    own (a leading space). The synthetic vocab's own surfaces there start
    no word, so each row of random weights would be one word. The suppress
    rules read only the byte tokens and the specials, which stay, so the
    decode's tokens do not change."""
    from whisper_tpu_torch.tokenizer.vocab import Vocab, num_languages_for

    table = {i: vocab.surface(i) if i < 256 else b" w%d" % i for i in range(vocab.specials.eot)}
    return Vocab(table, multilingual=vocab.multilingual, n_vocab=vocab.n_vocab,
                 num_languages=num_languages_for(n_vocab))


def phase_words(torch, kernels, beam, engine, phase4_results) -> dict:
    """Phase 7c (docstring): ``word_timestamps=True`` on phase 4's batch,
    then on its shortest utterance alone."""
    utts, batch, audio_s = main_path_batch()
    assets = dataclasses.replace(engine.assets, vocab=word_vocab(engine.vocab, engine.dims.n_vocab))
    eng = type(engine)(assets, dataclasses.replace(engine.config, word_timestamps=True), device=engine.device)
    results, wall, n = _timed(torch, kernels, beam, lambda: eng.transcribe_batch(batch))
    stages = eng.timer.summary()
    align_ms, dtw_ms = stages["align"].last_s * 1e3, stages["dtw"].last_s * 1e3 / len(results)
    window_s = max(LENGTHS_S)  # the batch's frames: JAX sizes the DTW by the longest row
    log(f"  7c: {wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; alignment forward {align_ms:.1f} ms "
        f"for the batch of {len(results)}, DTW {dtw_ms:.1f} ms of host time per row; launches {n}")
    _expect("7c", n, {"K1": LARGE_V3_ENC_LAYERS})  # the primary's encoder output is reused
    for r, ref, dur in zip(results, phase4_results, LENGTHS_S):
        if not _same_tokens(r, ref):
            fail("7c: word timestamps changed the tokens")
        times = [(w.start, w.end) for w in r.words]
        log(f"    {dur:.1f} s: {len(r.words)} words, first {times[:3]}, "
            f"{sum(e <= dur for _, e in times)} end within the utterance")
        if not r.words or any(not 0.0 <= s <= e <= window_s for s, e in times) or times != sorted(times):
            fail(f"7c: word times {times} unordered or outside [0, {window_s}]")
    single, wall1, n1 = _timed(torch, kernels, beam, lambda: eng.transcribe(utts[0]))
    times = [(w.start, w.end) for w in single.words]
    log(f"  7c, the {LENGTHS_S[0]:.1f} s utterance alone: {len(times)} words {times[:4]}...; "
        f"{wall1 * 1e3:.1f} ms; launches {n1}")
    _expect("7c single", n1, {"K1": LARGE_V3_ENC_LAYERS})
    if not times or any(not 0.0 <= s <= e <= LENGTHS_S[0] for s, e in times) or times != sorted(times):
        fail(f"7c single: word times {times} unordered or outside [0, {LENGTHS_S[0]}]")
    return {"audio_s_per_s": audio_s / wall, "wall_s": wall, "align_ms": align_ms,
            "dtw_host_ms_per_row": dtw_ms, "launches": n}


def bursts_and_silences(seconds: float, bursts, seed: int) -> np.ndarray:
    """``seconds`` of near-silence (noise at 1e-3) with synthetic speech at
    the ``(start_s, length_s)`` bursts."""
    rng = np.random.default_rng(seed)
    x = (1e-3 * rng.standard_normal(int(16_000 * seconds))).astype(np.float32)
    for i, (start, length) in enumerate(bursts):
        u = synthetic_utterance(length, seed + i)
        x[int(16_000 * start) : int(16_000 * start) + len(u)] += u
    return x


LONG_BURSTS = ((2.0, 8.0), (15.0, 10.0), (35.0, 6.0), (48.0, 12.0), (66.0, 7.0))


def phase_long_form(torch, kernels, beam, engine) -> dict:
    """Phase 7d (docstring)."""
    x = bursts_and_silences(75.0, LONG_BURSTS, 60)
    long, wall, n = _timed(torch, kernels, beam, lambda: engine.transcribe_long(x))
    log(f"  7d transcribe_long: 75.0 s in {wall * 1e3:.1f} ms → {75.0 / wall:.2f} audio-s/s; "
        f"{len(long.chunks)} chunks at {long.offsets} s; launches {n}")
    check_results(long.chunks, engine, engine.dims.n_vocab)
    if len(long.chunks) < 2 or long.offsets != sorted(set(long.offsets)):
        fail(f"7d transcribe_long: chunks at {long.offsets}")
    _expect("7d transcribe_long", n, {"K1": LARGE_V3_ENC_LAYERS})  # one batch, one encode

    seq_engine = _engine_with(engine, max_new_tokens=16)
    y = synthetic_utterance(35.0, 61)
    with _Spy(seq_engine, "_seq_window") as spy:
        seq, wall_s, n_s = _timed(torch, kernels, beam, lambda: seq_engine.transcribe_sequential(y))
    windows = len(spy.calls)
    starts = [s.start for s in seq.segments]
    log(f"  7d transcribe_sequential: 35.0 s, {windows} windows in {wall_s * 1e3:.1f} ms → "
        f"{35.0 / wall_s:.2f} audio-s/s; language {seq.language}, {seq.length} text tokens, "
        f"{len(seq.segments)} segments; launches {n_s}")
    if not 1 <= windows <= 35 or starts != sorted(starts) or not seq.language:
        fail(f"7d transcribe_sequential: {windows} windows, segment starts {starts}")
    _expect("7d transcribe_sequential", n_s, {"K1": LARGE_V3_ENC_LAYERS * (windows + 1)})  # + detection
    return {"long_audio_s_per_s": 75.0 / wall, "long_chunks": len(long.chunks), "long_launches": n,
            "sequential_windows": windows, "sequential_wall_s": wall_s,
            "sequential_audio_s_per_s": 35.0 / wall_s, "sequential_launches": n_s}


def k5_times(torch, mel_fused) -> dict:
    """K5 on the main path's batch ([4, 480000], 128 mels): the kernel
    alone and with its epilogue, device time, and the wrapper's host time
    per call. Works with any tree's ``frontend/mel_fused`` of the same
    signature (``--sweep-tree``)."""
    _, batch, _ = main_path_batch()
    x = torch.from_numpy(batch).cuda()
    out = {"ms": time_ms(lambda: mel_fused.log10_mel_kernel(x, 128)),
           "wrapper_ms": time_ms(lambda: mel_fused.log_mel_spectrogram_fused(x, n_mels=128)),
           "host_ms": host_ms_per_call(lambda: mel_fused.log10_mel_kernel(x, 128))}
    log(f"  K5 [4, 480000] 128 mels: kernel {out['ms']:.4f} ms, with the epilogue "
        f"{out['wrapper_ms']:.4f} ms, host {out['host_ms']:.4f} ms per call")
    return out


def sweep_tree(tree: str) -> None:
    """``--sweep-tree DIR``: only the sweeps of K2 (:func:`k2_sweep`) and K3
    (:func:`k3_sweep`) and K5's times (:func:`k5_times`), with the
    ``whisper_tpu_torch`` of the checkout at DIR (its kernels built there),
    so that two trees compare on one card; the last line is the JSON
    object of the three."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from whisper_tpu_torch.frontend import mel_fused
    from whisper_tpu_torch.ops import build, fused_step, gather_attend

    build.build([fused_step.KERNEL, gather_attend.KERNEL, mel_fused.KERNEL])
    log(f"sweeps of {os.path.dirname(os.path.dirname(fused_step.__file__))}; {card_line()}")
    print(json.dumps({"k2": k2_sweep(torch, fused_step), "k3": k3_sweep(torch, gather_attend, fused_step),
                      "k5": k5_times(torch, mel_fused)}))


def main() -> None:
    if sys.argv[1:2] == ["--sweep-tree"]:
        return sweep_tree(sys.argv[2])
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
    k2["cast_cases"] = phase_store_cast(torch, fused_step)
    k2["sweep"] = k2_sweep(torch, fused_step)
    k3 = phase_gather_attend(torch, gather_attend, fused_step)
    k3["sweep"] = k3_sweep(torch, gather_attend, fused_step)
    k5 = phase_mel_fused(torch, mel_fused)

    log("[4] main path: large-v3, greedy, bf16, language detection")
    k1["launches"], main_engine, main_results = phase_main_path(
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

    log("[5] card against CPU: tiny, float32, TF32 off")
    phase_card_vs_cpu(torch, EngineConfig, Monolith)

    log("[6a] serving: the slot pool, large-v3, greedy, bf16, audio_ctx=None")
    serve_engine, pools = phase_serving(torch, kernels, EngineConfig, EngineType, create_engine)
    log("[6b] serving: the async micro-batcher over the flagship (beam 5, int8, fp8 KV)")
    flagship = phase_async_flagship(torch, kernels, beam, beam_engine)
    log("[6c] serving: HTTP, continuous mode, over the 6a engine")
    phase_http(serve_engine)
    del serve_engine
    serving = {p["class"]: p for p in pools}
    serving["AsyncTranscriber"] = flagship
    log(f"serving record: {json.dumps(serving)}")
    k1["serving_launches"] = {name: rec["k1"] for name, rec in serving.items()}
    k2["serving_launches"] = {name: rec.get("k2", 0) for name, rec in serving.items()}
    for rec in (k2s, k3, k4, k5):
        rec["serving_launches"] = {name: 0 for name in serving}

    t7 = time.perf_counter()
    log("[7a] the fallback ladder: large-v3 greedy bf16, default ladder and gates (phase 4's weights)")
    options = {"7a": phase_ladder(torch, kernels, beam, main_engine, "7a")}
    options["7a_gates_off"] = phase_ladder_gates_off(torch, kernels, beam, main_engine, main_results)
    log("[7b] the fallback ladder over the flagship: beam 5 primary, sampling retries (phase 4b's weights)")
    options["7b"] = phase_ladder(torch, kernels, beam, beam_engine, "7b")
    del beam_engine
    log("[7c] word timestamps: large-v3 greedy bf16 on phase 4's batch")
    options["7c"] = phase_words(torch, kernels, beam, main_engine, main_results)
    log("[7d] long form: transcribe_long (VAD chunks) and transcribe_sequential (seek loop)")
    options["7d"] = phase_long_form(torch, kernels, beam, main_engine)
    del main_engine
    log(f"options record: {json.dumps(options)}; phase 7 took {time.perf_counter() - t7:.1f} s")
    names = ("K1", "K2", "K2′", "K3", "K4", "K5")
    for name, rec in zip(names, (k1, k2, k2s, k3, k4, k5)):
        rec["options_launches"] = {
            "7a": options["7a"]["launches"][name], "7b": options["7b"]["launches"][name],
            "7c": options["7c"]["launches"][name], "7d_long": options["7d"]["long_launches"][name],
            "7d_sequential": options["7d"]["sequential_launches"][name],
        }

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
