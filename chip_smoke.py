#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisper_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. Card: name and power limit (nvidia-smi), compute capability (must be 9.0).
2. Build: every kernel of the main path, with nvcc from the sources in
   ``whisper_tpu_torch/csrc/`` (into ``build/whisper_tpu_torch/``).
3. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and a few others, with the tolerance stated (K1: 4 bf16
   ulps; K2 and K4 move bytes: bitwise); times of the kernel, the plain
   version and the library call beside the bound.
4. Greedy main path at full width: ``create_engine(MONOLITH, EngineConfig(
   model="large-v3", max_new_tokens=64), device="cuda")`` with random
   weights from a seed; ``transcribe_batch`` of 4 utterances of different
   lengths and ``transcribe`` of a WAV file. Launch counts are set to 0
   just before and read just after: K1 must run once per encoder layer of
   every encode, K2 and K4 never. Prints audio-s/s, encoder ms and decode
   ms/token.
4b. Beam main path at full width: the same with ``beam_size=5,
   quantization="int8", kv_cache_dtype="float8_e4m3fn"`` and
   ``fused_step`` left at "auto" (K2's "hybrid" on the card): K2 must run
   once per decoder layer of every decode step, K4 never. Then
   ``fused_step="off"`` on the same weights: K4 twice per step (K and V),
   K2 never, and tokens equal to the hybrid run's (the two modes run the
   same arithmetic on the same bytes).
5. Kernel path against the CPU path end to end: ``tiny`` dims in float32,
   TF32 off for matmuls and cuDNN, the same weights on the card and on the
   CPU must give equal tokens for a batch of 2: greedy; beam 3 with the
   card's "hybrid", the card's "off" and the CPU's "off"; and beam 3 with
   int8 weights and the fp8 KV cache, card "hybrid" against CPU "off".

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
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("large-v3 encoder", (4, 1500, 20, 64), torch.bfloat16),
        ("tiny encoder", (4, 1500, 6, 64), torch.bfloat16),
        # The mask check: 28 of the last K/V tile's 64 keys lie past T. At
        # T=1500 only 36 of 1536 keys are masked, too few for the tolerance
        # to catch a kernel that gives them weight.
        ("ragged T=100", (4, 100, 20, 64), torch.bfloat16),
        ("dev encoder, Dh=32", (4, 1500, 2, 32), torch.bfloat16),
        ("tiny encoder f32", (2, 1500, 6, 64), torch.float32),
        ("f32 Dh=32, T=300", (2, 300, 2, 32), torch.float32),
    ]
    record = None
    before = attention.launches
    for name, shape, dtype in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = attention.fused_self_attention(q, k, v)
        torch.cuda.synchronize()
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
            log(f"    plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms")
            record = {
                "name": "flash_attn_fwd", "route": "cuda",
                "source": "whisper_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": "whisper_tpu/ops/attention.py:33",
                "launches": None, "max_abs_err": err, "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms, "shape": list(shape), "dtype": "bfloat16",
            }
    if attention.launches == before:
        fail("K1 wrapper never launched its kernel")
    return record


def _as_bytes(t):
    import torch

    return t.contiguous().view(torch.uint8)


def bytes_bound_ms(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES * 1e3


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


def phase_main_path(torch, kernels, EngineConfig, EngineType, create_engine) -> int:
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather = kernels
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
    enc_out = engine._encode(host)
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
    if fused_step.launches or gather.launches:
        fail(f"greedy launched K2 {fused_step.launches} and K4 {gather.launches} times")

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
    counts of their runs."""
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather = kernels
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
    enc_out = engine._encode(host)
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
    # counts end here
    log(
        f"  fused_step='off': {wall_off * 1e3:.1f} ms → {audio_s / wall_off:.2f} audio-s/s; "
        f"K2 {k2_off}, K4 {k4_off} ({steps_off} steps × 2)"
    )
    if k2_off != 0 or k4_off != 2 * steps_off or steps_off == 0:
        fail(f"off: K2 launched {k2_off} times (expected 0), K4 {k4_off} (expected {2 * steps_off})")
    for a, b in zip(results, results_off):
        if not np.array_equal(a.tokens, b.tokens) or a.length != b.length:
            fail(f"hybrid and off tokens differ: {a.tokens[:a.length].tolist()} vs {b.tokens[:b.length].tolist()}")
    log("  hybrid and off tokens equal")
    return k2, k4_off


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


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    t_start = time.perf_counter()
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import beam
    from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
    from whisper_tpu_torch.ops import attention, build, fused_step, gather

    log("[1] card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}; capability {cap}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    log("[2] build")
    t0 = time.perf_counter()
    kernels = (attention, fused_step, gather)
    built = build.build([k.KERNEL for k in kernels])
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (secs, ptxas) in built.items():
        usage = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))

    log("[3] kernels against their plain versions")
    records = [
        phase_kernels(torch, attention),
        phase_permute_append(torch, fused_step),
        phase_permute_rows(torch, gather),
    ]

    log("[4] main path: large-v3, greedy, bf16, language detection")
    records[0]["launches"] = phase_main_path(
        torch, kernels, EngineConfig, EngineType, create_engine
    )

    log("[4b] beam main path: large-v3, beam 5, int8 weights, fp8 KV cache, bf16")
    records[1]["launches"], records[2]["launches"] = phase_beam_path(
        torch, kernels, beam, EngineConfig, EngineType, create_engine
    )

    log("[5] card against CPU: tiny, float32, TF32 off")
    phase_card_vs_cpu(torch, EngineConfig, Monolith)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
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
