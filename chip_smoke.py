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
   ``unbind`` views; its f32 body at 1e-5 × max(1, max|ref|), at T = 1,
   100, 256, 1499 and 1500, Dh = 32 at T = 64, 300 and 1500, ``unbind``
   views; K2 and K4 move bytes: bitwise; K3: planes bitwise, attention 4 bf16
   ulps or 1e-5 in f32, and JAX's tolerances against
   ``reference_gather_attend``, with f32 and bf16 new rows, which the
   kernel converts itself: one kernel per call (profiler), timed with bf16
   rows as ``utils/probe_fused.py`` passes them, at pos 4 (its floor) and
   beside K2 on the same call; K5: 2e-4 in log-mel units, also against
   ``frontend/mel.py``, its rate on its own operation count); times of
   the kernel, the plain version and the library call (or the nearest
   composite, labelled) beside the bound;
   K1 and ``scaled_dot_product_attention`` also at T = 256, 512, 1024 and
   1500 at large-v3 width (batch 4, 20 heads), one line per T, and at a
   ``tiny`` draft encoder's shape [4, 1500, 6, 64] in bf16 (phase 8a's
   draft of its own frontend) beside its plain version, the library call
   and the bound; the f32 body likewise at both shapes the f32 paths give
   it, [4, 1500, 6, 64] and large-v3's [4, 1500, 20, 64]; and K1 at the
   local heads of a tensor-parallel rank, [4, 1500, 10, 64] (large-v3 at a
   model axis of 2), in bf16 and f32, beside its plain version, the library
   call and the bound, with the f32 launch plan.
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
   default config's cache); K2 reading its position from an int64 on the
   card (a captured decode step's form) at the flagship's planes [2, 32,
   80, 228, 1280] fp8 with bf16 rows, launched directly and replayed from
   two captured graphs (one per read parity) while the position advances,
   bitwise at each position and both parities, one kernel per call and
   per replay (profiler), timed beside the launch-argument form; K3 over the same points beside K2, checked
   against its plain version at each. K6 (``ops/fp8_upcast``) bitwise, NaN
   codes NaN: all 256 codes of float8_e4m3fn and float8_e5m2, one layer's
   plane of the cross probe's defaults [20480, 1500] (timed beside
   ``.to(torch.bfloat16)`` and the bound), element counts that are not a
   multiple of 16 and one row; a sliced view and a misaligned base refused.

    python3 chip_smoke.py --sweep-tree DIR   # the K2 and K3 sweeps and K5's times alone, DIR's kernels
    python3 chip_smoke.py --k1-tree DIR      # K1's f32 cases and times alone, DIR's kernel
4. Greedy main path at full width: ``create_engine(MONOLITH, EngineConfig(
   model="large-v3", max_new_tokens=64), device="cuda")`` with random
   weights from a seed; ``transcribe_batch`` of 4 utterances of different
   lengths and ``transcribe`` of a WAV file. Launch counts are set to 0
   just before and read just after: K1 must run once per encoder layer of
   every encode, K2, K3, K4 and K5 never. Prints audio-s/s, encoder ms and
   decode ms/token, and ``utils/roofline.utilization`` of the timed batch
   (mfu, hbm_utilization, sol_decode_s) at the card's peaks.
4b. Beam main path at full width: the same with ``beam_size=5,
   quantization="int8", kv_cache_dtype="float8_e4m3fn"`` and
   ``fused_step`` left at "auto" (K2's "hybrid" on the card): K2 must run
   once per decoder layer of every decode step, K3, K4 and K5 never; in
   one more decode, whose steps are all graph replays, K2's kernels
   counted in a profiler trace must be 32 per step and equal the count. Then
   ``fused_step="off"`` on the same weights: K4 twice per step (K and V),
   K2 never, and tokens equal to the hybrid run's (the two modes run the
   same arithmetic on the same bytes). The roofline line as in phase 4.
   Then the quantisation witness: ``quantize_params`` of phase 4's tree on
   the card equals the same call on the host bitwise, leaf by leaf, and
   equals the flagship engine's own tree.
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
4e. The tensor-parallel path at full width: large-v3 bf16 with
   ``mesh_shape=(1, 2)``, two processes of ``parallel/_dist_worker`` that
   share this card over gloo (a proof of the arithmetic, not a scaling
   number: NCCL refuses two ranks on one card), phase 4's weights and 4
   utterances with a 32-token budget, greedy and then phase 4b's flagship
   (beam 5, int8, fp8 KV, "auto", which is "off" on a model axis > 1).
   The ranks restore from an npz of phase 4's weights, written into a
   temporary directory and removed afterwards (``--checkpoint``: each rank
   reads only its slice, the flagship's quantised as it is read). Each
   rank holds about half of phase 4's parameter bytes, its checksum equals
   ``shard_params`` of this process's tree at its index (the flagship's:
   phase 4b's tree, quantised on the card, which 4b holds equal to the
   host's quantisation the ranks make as they read), and its
   ``max_memory_allocated`` is below the whole tree's bytes (printed with
   the restore's host ms and the peaks measured when each rank drew the
   whole tree on the card, ``TP_PEAK_FROM_RANDOM_GB``); launches per rank exactly K1 32 per encode (its 10
   local heads), K4 twice per beam step, K2, K2′, K3 and K5 never;
   collectives exactly 64 per encode and 98 per decoder forward (the
   embedding's gather, o, cross o and fc2 of 32 layers, the logits) for
   the detection, the prefill and every step, counted apart; both ranks
   return the same results, and tokens equal this process's engine at the
   same budget but for a flip where its top-2 gap is < 0.25 (as 8b
   allows; a beam row's gap is the beam's own margin, and a token outside
   its beam's top K + 1 fails; each flip printed with its gap). A
   row-parallel product is summed from f32 partials and rounded once,
   where this process rounds twice. An encode and a decode timed
   apart: decode ms per token and host ms in collectives.
4f. The batch stream at full width: ``Monolith.transcribe_batches`` of 4
   batches (4, 4, 3 and 4 utterances of 1.5–30 s: "auto" crops 512, 256,
   1024 and the full window; the batch of 3 pads a silent row) against a
   loop of ``transcribe_batch`` on the same engine, in turns (loop, stream,
   stream, loop: the host's load drifts), greedy bf16 (phase 4's, 64
   tokens) and the flagship (phase 4b's). Tokens and text of every run
   equal the first loop's row for row; each run's launches exactly K1 32 ×
   4, K2 32 × the beam steps (the flagship; 0 greedy), K2′, K3, K4 and K5
   never; every
   encode's enqueue runs under ``torch.cuda.set_sync_debug_mode("error")``
   (which must first be seen to raise on an ``.item()``), on an encode
   stream that is not the decode's. Prints audio-s/s and the decode's
   device-clock ms per token both ways, ``max_memory_allocated``, and the
   overlap witness: for each batch i, whether encode(i+1)'s end event lies
   inside decode(i)'s window, the ms between them, and encode(i+1)'s host
   ms to enqueue beside its window on the encode stream.
4g. K6's path at full width: ``utils/probe_cross.run`` at JAX's defaults
   (large-v3, batch 16, beam 5, Tk 1500, fp8 K/V, 1 + 16 iterations) in
   its six modes, each with its launch counts set to 0 just before and
   read just after: K6 exactly 2 × 32 × 17 under "dmastage" and never
   otherwise, the cross-attention kernel exactly 32 × 17 under "kernel"
   and never otherwise, K1–K5 never; the final q of "prod", "stage" and
   "dmastage" bitwise equal, "chunk" and "kernel" within 4 bf16 ulps of
   "prod" at max|q|, every q finite. Then turbo's shape (beam 1, a bf16
   store) in "bf16" and "kernel" (kernel 32 × 17, within 4 bf16 ulps of
   "bf16"). Prints each mode's ms per 32-layer iteration (CUDA events,
   the host's enqueue included: the kernel mode's 32 launches an
   iteration are paced by the host) and the device ms of one iteration's
   kernels (profiler), the rate over its window read, the bytes its ops
   move, the fp8 window's bound and its device launches per iteration.
5. Kernel path against the CPU path end to end: ``tiny`` dims in float32,
   TF32 off for matmuls and cuDNN, the same weights on the card and on the
   CPU must give equal tokens for a batch of 2: greedy; beam 3 with the
   card's "hybrid", the card's "off" and the CPU's "off"; beam 3 with int8
   weights and the fp8 KV cache, card "hybrid" against CPU "off", where a
   row may leave the CPU's tokens only at a CPU beam margin below 0.25
   (each flip printed; a token outside its beam's top K + 1 fails); and beam
   3 on two ranks on the card (``mesh_shape=(2, 1)``) under "hybrid" (K2′)
   and "off" against CPU "off"; and tensor parallelism on the card, on
   ``mesh_shape=(1, 2)`` and ``(2, 2)`` (four processes on one card):
   greedy, beam 3 "off" and beam 3 int8 + fp8 KV, every rank's tokens equal
   to the CPU's single process (int8 + fp8 KV: under the same near-tie
   rule). Then serving, ``audio_ctx=None``, on
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
   card, MT19937 on the CPU, so sampled tokens are not compared.) And
   speculative decoding: with ``max_new_tokens=None`` (the decode
   reaches the end of the 448-token context) a random ``tiny`` draft and a
   self-draft on the card, and the self-draft on the CPU, give the card's
   greedy tokens; a ``dev`` draft (another encoder width, so its own mel
   and encoder) gives greedy's tokens on the card and the CPU's.
6. Serving at full width, large-v3 (``engine/serving.py``,
   ``engine/http_server.py``):
6a. The slot pool: greedy bf16, ``audio_ctx=None``, phase 4's weights,
   64-token budget; ``ContinuousTranscriber(n_slots=8, prefill_batch=2)``,
   then ``DisaggregatedTranscriber`` with the same arguments, each given 8
   utterances of 2–19.5 s in two waves (one result of a wave awaited before
   the next is submitted; two waves, not three, keep the whole run inside
   its time budget). Every future resolves within its timeout and
   passes ``check_results``; K1 launches exactly 32 × the prefill
   dispatches, K2, K2′, K3, K4 and K5 never. Prints request latency p50/p95
   (submit → result), audio-s/s, occupancy, dispatch efficiency and
   macro-steps, and (information only) token agreement with
   ``engine.transcribe`` of each utterance of the first wave (the first
   wave only, for the run's time budget).
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
   gates on phase 4's 4 utterances, a 32-token budget (for the run's time
   budget; the ladder's six runs kept): every temperature in
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

8. Speculative decoding at full width (``decode/speculative.py``), every
   launch count set to 0 just before each run and checked exactly after:
8a. large-v3 in float32 (TF32 off), phase 4's batch, a 32-token budget
   (for the run's time budget):
   greedy, then three drafts at k = 4: a self-draft (the target's own
   weights: every draft accepted, ⌈31 / 5⌉ rounds when a row runs to the
   budget), a random ``distil-large-v3`` (shares the target's encoder
   output: K1 32) and a random ``tiny`` (its own mel and encoder: K1 32 +
   4). Tokens must equal greedy's exactly; rounds and acceptance printed,
   and the f32 mel + encoder's ms per batch (K1's f32 body: 32 launches).
8b. The default bf16 config on phase 4's weights with a random
   ``distil-large-v3`` draft, timed beside greedy in the same phase: rounds,
   acceptance, rows equal to phase 4's tokens. bf16 window and step logits
   differ by reduction order (JAX measured up to 0.064 at large-v3), and
   random weights leave thin margins: a row may leave phase 4's tokens only
   where the target's top-2 gap at its first differing position (teacher-
   forced, the rules applied) is below 0.25, else the phase fails.
9. The CLI on the card: subprocesses of ``python -m whisper_tpu_torch.cli``
   (their launch counts printed at exit) on two WAV files the script
   writes: ``transcribe`` at large-v3 greedy with ``--output-format all``
   (five files per input), with ``--draft-model distil-large-v3``, and with
   the flagship flags (K2 > 0, 32 per beam step); ``convert`` of an
   openai-format ``.pt`` of random ``tiny`` weights, ``transcribe
   --checkpoint`` of the npz (text and lengths equal to the in-process
   engine's on the same file), and ``info``. Every run exits 0.
10. The native host loader and the C ABI (``whisper_tpu_torch/native``):
   the host library built with g++ and ``load_native()`` not None;
   ``load_batch`` of 8 WAVs bitwise equal to the Python readers (both
   timed on the host clock); ``transcribe_files`` at ``tiny`` with the
   loader equal to it without; then the C-ABI library and its driver built
   against this interpreter, and the C driver, as a subprocess that embeds
   Python, transcribes a WAV with ``tiny`` random weights (seed 0) on
   ``cuda``: its text equals this process's engine's.

11. The repo's measurement entry points on the card, at full width
   (large-v3), every launch count set to 0 just before each sub-phase and
   checked exactly just after it:
11a. ``utils/bench.run`` (bench.py's harness) on phase 4b's weights: the
   flagship's knobs (beam 5, int8, fp8 KV, bf16, "auto") at batch 4, 32
   tokens, 1 repeat: K1 32 × the encodes (warm-up, serialized, pipelined:
   5), K2 32 × the beam steps; the last batch's tokens equal a plain
   ``transcribe_batch`` of the same batch on the same engine; ``mfu`` and
   ``hbm_utilization`` within (0, 1.05]; the record printed. Then the same
   at ``BENCH_BEAM=1``: K2 never.
11b. ``utils/bench_serving.run`` (``tools/bench_serving.py``) on phase
   4's weights, greedy bf16: ``--n 8 --slots 4 --prefill-batch 2
   --max-new 16``, its three front-ends. Every future resolves within its
   timeout, each utterance decodes 1–16 tokens, K1 32 × each front-end's
   prefill dispatches or flushes; each record printed.
11c. ``utils/ablate_step.run`` (``tools/ablate_step.py``) at batch 4,
   beam 5, fp8 cache, int8 weights, 4 iterations: every row printed; K3
   32 × the fused row's iterations and K4 2 × the K4 row's, 0 in every
   other row; the reorders by ``index_select``, K4 (and the int8 product,
   where ``torch._int_mm`` takes the shape) bitwise equal, the one-hot
   product equal in value with −0 → +0 its only byte change; one iteration
   of the fused row held layer by layer against K3's plain version on the
   same inputs (planes bitwise, attention 4 bf16 ulps).

12. The routed experts of Uni-MoE-2.0-Omni (``ops/moe_expert``,
   ``csrc/moe_expert.cu``), at its published widths (d 3584, f 18944, 4
   routed experts):
12a. The wrapper against its plain version on the same card tensors at the
   decode's shape (64 tokens) and the cell's longest prefill (14,848
   tokens), routed by ``models/audio_lm.route`` on a random f32 gate:
   every routed row of y within 5e-3 (relative L2) of the plain version's,
   rows routed nowhere exactly 0, counts equal, 2 launches counted a call;
   the same test run on a routing with one expert's rows dropped must fail
   it. Times (the wrapper, each kernel from a profiler trace, the plain
   version, the nearest library composite: bf16 matmuls of each expert's
   rows and ``index_add_``) beside the bound. ``--moe --sweep``: every
   pair of the kernel table's variants at both shapes.
12b. The main path: ``create_engine(MONOLITH, EngineConfig(model=
   "uni-moe-2.0-omni", max_new_tokens=32, ...))`` with random weights,
   ``transcribe_batch`` of 64 clips of 4–20 s, twice after a warm batch,
   launch counts set to 0 just before each: 2 launches per layer of the
   prefill and of each step, every step replayed from its graph; the
   second run under the profiler, whose ``moe_expert*`` kernels equal its
   count; the two runs' tokens equal and well formed.

    python3 chip_smoke.py --moe [--sweep]   # phases 1, 2 (its kernels) and 12 alone

13. The cross-attention kernel (``ops/cross_attend``,
   ``csrc/cross_attend.cu``):
13a. Against its plain version on the same card tensors, within 2 bf16
   ulps of the output's largest magnitude, one launch a call, at the
   flagship's step [16 rows, 5 queries, 20 heads, 64, Tk 1500] e4m3,
   turbo's [16, 1, 20, 64, 1500] bf16, the flagship's prefill (20
   queries), a tensor-parallel rank's 10 heads and a crop of 512 in e5m2;
   the kernel's, the plain version's and the bound's ms a layer (bytes:
   K and V stored, q and the output once), on a bf16 store the library's
   one call for the same function (``F.scaled_dot_product_attention`` on
   the stored layout's transposes, and on K and V copied to [B, H, Tk, 64]
   first), and the host's ms to enqueue a call of each.
13b. The flagship's decode at large-v3 width (random int8 weights, an fp8
   cache, beam 5, "hybrid", 16 rows, 32 tokens), replayed from captured
   graphs, twice: ``launches`` exactly 32 for the prefill and for every
   step, replays included; the second run under the profiler, whose
   ``cross_attend*`` kernels equal that count.
   (The probe's 32-layer pass with the kernel runs in phase 4g; the
   kernel's launches on every path are counted in the phases of each.)

    python3 chip_smoke.py --cross   # phases 1, 2 (its kernel) and 13 alone

The cross-attention kernel's launches (``ops/cross_attend``) are counted
in every phase that runs a Whisper decoder in this process (4, 4b, 4f, 6a,
6b, 7, 8, 9's processes, 11, 13b) beside a witness, :class:`CrossWitness`:
the bf16 decoder forwards on the card, each worth its layers, a captured
step counted at each replay and not at its capture. The launches must
equal the witness's layers (32 per large-v3 forward), above 0 on a bf16
path and 0 on an f32 one; 11c's cross row adds its own 32 a iteration;
4d's and 4e's ranks report 32 per decoder forward (the detection, the
prefill and each step). Phases 4 and 4b then run ``transcribe_batch``
on their weights at a 16-token budget under the profiler (after one run
that captures its steps): its ``cross_attend*`` kernels equal that run's
launches and its witness (a trace short of them, as one that dropped
records is, taken again up to 3 times; one that holds more fails).

Then, each on a line of its own: the kernels' JSON record (the
cross-attention kernel's last: its times at phase 13a's shapes and its
launches on each path), the card's name and power limit, and the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
LARGE_V3_ENC_LAYERS = 32
LARGE_V3_DEC_LAYERS = 32
FP8 = "float8_e4m3fn"
TP_LOCAL_SHAPE = (4, 1500, 10, 64)  # K1 on one rank of large-v3 at a model axis of 2


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


K1_CASES = [
    ("large-v3 encoder", (4, 1500, 20, 64), "bfloat16"),
    ("tiny encoder", (4, 1500, 6, 64), "bfloat16"),
    # The mask check: 28 of the last K/V tile's 128 keys lie past T (one
    # ragged tile). At T=1500, 36 of 1536 keys are masked, too few for
    # the tolerance to catch a kernel that gives them weight.
    ("ragged T=100", (4, 100, 20, 64), "bfloat16"),
    ("one key T=1", (4, 1, 20, 64), "bfloat16"),
    ("bucket T=256 (no mask)", (4, 256, 20, 64), "bfloat16"),
    ("bucket T=512 (no mask)", (4, 512, 20, 64), "bfloat16"),
    ("bucket T=1024 (no mask)", (4, 1024, 20, 64), "bfloat16"),
    ("ragged T=1499", (4, 1499, 20, 64), "bfloat16"),
    ("dev encoder, Dh=32", (4, 1500, 2, 32), "bfloat16"),
    ("Dh=32, T=64", (4, 64, 4, 32), "bfloat16"),
    ("unbind views", (2, 300, 4, 64), "bfloat16 strided"),
    ("unbind views, Dh=32", (2, 300, 4, 32), "bfloat16 strided"),
    # f32: the f32 body's 64-key tiles leave 36 keys of T=100's one tile
    # and 28 of T=1500's last past T.
    ("large-v3 encoder f32", (4, 1500, 20, 64), "float32"),
    ("tiny encoder f32", (2, 1500, 6, 64), "float32"),
    ("f32 one key T=1", (4, 1, 20, 64), "float32"),
    ("f32 ragged T=100", (4, 100, 20, 64), "float32"),
    ("f32 bucket T=256 (no mask)", (4, 256, 20, 64), "float32"),
    ("f32 ragged T=1499", (4, 1499, 20, 64), "float32"),
    ("f32 dev encoder, Dh=32", (4, 1500, 2, 32), "float32"),
    ("f32 Dh=32, T=64", (4, 64, 4, 32), "float32"),
    ("f32 Dh=32, T=300", (2, 300, 2, 32), "float32"),
    ("f32 unbind views", (2, 300, 4, 64), "float32 strided"),
    ("f32 unbind views, Dh=32", (2, 300, 4, 32), "float32 strided"),
]


def k1_inputs(torch, gen, shape, dtype: str) -> tuple:
    """q, k, v on the card: three tensors, or (``strided``) the ``unbind``
    views of one fused [B, T, 3, H, Dh] projection."""
    dt = getattr(torch, dtype.split()[0])
    if dtype.endswith("strided"):
        b, t, h, dh = shape
        return torch.randn((b, t, 3, h, dh), generator=gen, device="cuda").to(dt).unbind(2)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))


def k1_check(torch, attention, q, k, v, name: str) -> tuple:
    """One launch of K1 against its plain version, with the tolerance of
    phase 3 (bf16: 4 ulps at the output's largest magnitude; f32: 1e-5 ×
    max(1, max|ref|)). Fails unless the wrapper launched once and agrees.
    Returns (max_abs_err, max|ref|, tolerance)."""
    before = attention.launches
    out = attention.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    if attention.launches != before + 1:
        fail(f"K1 wrapper did not launch its kernel once at {name}")
    ref = attention.fused_self_attention_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = bf16_tolerance(ref_max) if q.dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
    if not bool(torch.isfinite(out).all()) or err > tol:
        fail(f"K1 disagrees with its plain version at {name} {list(q.shape)} {q.dtype}: {err} > {tol}")
    return err, ref_max, tol


def k1_cases(torch, attention, gen, dtypes=("bfloat16", "float32")) -> dict:
    """Every case of :data:`K1_CASES` whose dtype is in ``dtypes``, checked
    (:func:`k1_check`) and timed beside its bound. Returns {name: (err,
    kernel ms)}."""
    out = {}
    for name, shape, dtype in K1_CASES:
        if dtype.split()[0] not in dtypes:
            continue
        q, k, v = k1_inputs(torch, gen, shape, dtype)
        err, ref_max, tol = k1_check(torch, attention, q, k, v, name)
        kern_ms = time_ms(lambda: attention.fused_self_attention(q, k, v))
        bound, bound_by = attention_bound_ms(*shape, q.element_size())
        log(f"  K1 {name} {list(shape)} {dtype}: max_abs_err {err:.3g} (max|ref| {ref_max:.3g}, "
            f"rel {err / ref_max:.3g}, tol {tol:.3g}) kernel {kern_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        out[name] = (err, kern_ms)
    return out


def k1_timed(torch, attention, gen, shape, dtype: str) -> dict:
    """K1 at one shape: checked, then the kernel, its plain version and
    ``scaled_dot_product_attention`` timed in this run beside the bound.
    In f32 the library call is PyTorch's memory-efficient kernel, which
    runs split TF32 (``OpMultiplyAddFastF32``) on the tensor cores at f32
    accuracy; the bound is the f32 FMA rate, the kernel's own route."""
    import torch.nn.functional as F

    q, k, v = k1_inputs(torch, gen, shape, dtype)
    err, _, tol = k1_check(torch, attention, q, k, v, f"{dtype} {list(shape)}")
    kern_ms = time_ms(lambda: attention.fused_self_attention(q, k, v))
    plain_ms = time_ms(lambda: attention.fused_self_attention_reference(q, k, v))
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    )
    bound, bound_by = attention_bound_ms(*shape, q.element_size())
    flops = 4.0 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
    plan, extra = "", {}
    if dtype == "float32" and hasattr(attention, "f32_plan"):  # an older tree's K1 has none
        warps, per_sm, regs = attention.f32_plan(*shape)
        plan = f" ({warps} warps per CTA, {per_sm} CTAs per SM, {regs} registers)"
        extra = {"warps": warps, "ctas_per_sm": per_sm, "registers": regs}
    log(f"  K1 {list(shape)} {dtype}{plan}: max_abs_err {err:.3g} (tol {tol:.3g}); kernel {kern_ms:.4f} ms "
        f"({flops / kern_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); kernel / library {kern_ms / lib_ms:.3f}, "
        f"bound / kernel {bound / kern_ms:.3f}")
    return {"shape": list(shape), "dtype": dtype, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by, **extra}


TINY_ENC_SHAPE = (4, 1500, 6, 64)  # a tiny draft's encoder at phase 8a's batch
K1_F32_SHAPES = (TINY_ENC_SHAPE, (4, 1500, 20, 64))  # and large-v3's f32 encoder


def k1_f32(torch, attention, gen) -> dict:
    """K1's f32 body at the shapes the f32 paths give it (phase 8a: the
    tiny draft's encoder and large-v3's), each timed beside its plain
    version, the library call and the bound (:func:`k1_timed`). The record
    is large-v3's, with both shapes under ``per_shape``."""
    per_shape = [k1_timed(torch, attention, gen, shape, "float32") for shape in K1_F32_SHAPES]
    return {"name": "flash_fwd_f32", "route": "cuda", "source": "whisper_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "whisper_tpu/ops/attention.py:33", **per_shape[-1], "launches": None,
            "per_shape": per_shape}


def phase_kernels(torch, attention) -> dict:
    """K1 against its plain version at every case of :data:`K1_CASES` (the
    encoder's ``audio_ctx`` buckets and ragged lengths at 20 heads, Dh =
    32, ``unbind`` views of one [B, T, 3, H, Dh] projection, in bf16 and
    f32); the record is the main path's shape in bf16, timed beside the
    plain version and ``scaled_dot_product_attention``. Then one line per
    T ∈ {256, 512, 1024, 1500} at large-v3 width (batch 4, 20 heads): K1,
    ``scaled_dot_product_attention`` and the bound; the tiny draft's shape
    in bf16; and the f32 body at both f32 shapes (:func:`k1_f32`)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = k1_cases(torch, attention, gen)
    shape = (4, 1500, 20, 64)
    q, k, v = k1_inputs(torch, gen, shape, "bfloat16")
    main = k1_timed(torch, attention, gen, shape, "bfloat16")
    host_ms = host_ms_per_call(lambda: attention.fused_self_attention(q, k, v))
    log(f"    the wrapper's host time per call (checks, three tensor-map encodes, ctypes, "
        f"allocation) {host_ms:.4f} ms")
    record = {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "whisper_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "whisper_tpu/ops/attention.py:33",
        "launches": None, **main, "max_abs_err": max(errs["large-v3 encoder"][0], main["max_abs_err"]),
        "host_ms": host_ms,
    }
    per_t = []
    for t in (256, 512, 1024, 1500):
        shape = (4, t, 20, 64)
        q, k, v = k1_inputs(torch, gen, shape, "bfloat16")
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
    record["draft_shape"] = k1_timed(torch, attention, gen, TINY_ENC_SHAPE, "bfloat16")
    record["f32"] = k1_f32(torch, attention, gen)
    log(f"  K1 at a tensor-parallel rank's local heads {list(TP_LOCAL_SHAPE)} (large-v3, model axis 2):")
    record["tp_local_heads"] = {
        dt: k1_timed(torch, attention, gen, TP_LOCAL_SHAPE, dt) for dt in ("bfloat16", "float32")
    }
    return record


def k1_tree(tree: str) -> None:
    """``--k1-tree DIR``: only K1's f32 body, with the ``whisper_tpu_torch``
    of the checkout at DIR (its kernel built there), so that two trees
    compare on one card: every f32 case of :data:`K1_CASES` checked and
    timed, then :func:`k1_f32`; the last line is the JSON object of the
    f32 record."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from whisper_tpu_torch.ops import attention, build

    for name, (secs, ptxas) in build.build([attention.KERNEL]).items():
        usage = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))
    log(f"K1 f32 of {os.path.dirname(os.path.dirname(attention.__file__))}; {card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_cases(torch, attention, gen, dtypes=("float32",))
    record = k1_f32(torch, attention, gen)
    record["mel_encoder_ms"] = f32_encoder_ms(torch, attention)
    print(json.dumps(record))


def f32_encoder_ms(torch, attention, eng=None) -> float:
    """Phase 8a's f32 mel + encoder (large-v3, TF32 off, phase 4's batch;
    ``eng``, or a new engine of random weights) on the synchronised host
    clock, median of 3 after a warm-up; K1 must launch 32 times per
    encode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if eng is None:
        from whisper_tpu_torch.config import EngineConfig
        from whisper_tpu_torch.engine import EngineType, create_engine

        eng = create_engine(EngineType.MONOLITH, EngineConfig(model="large-v3", dtype="float32"), seed=0,
                            device="cuda")
    host, _, _ = eng._prepare_batch(main_path_batch()[1])
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        before = attention.launches
        t0 = time.perf_counter()
        eng._encode(host, eng._resolve_audio_ctx(host))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if attention.launches - before != LARGE_V3_ENC_LAYERS:
            fail(f"K1 launched {attention.launches - before} times in one f32 encode")
    ms = statistics.median(times[1:])
    log(f"  8a large-v3 f32 mel+encoder, batch 4: {ms:.1f} ms (median of "
        f"{', '.join(f'{x:.1f}' for x in times[1:])} after a warm-up; host clock, synchronised)")
    return ms


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


FLAGSHIP_PLANES = (2, 32, 80, 228, 1280)  # large-v3 batch 16 × beam 5, a 4-token prompt + 224 tokens
DEVICE_POS_RUNS = ((0, 4), (111, 3), (224, 4))  # (first position, steps): both parities, up to ctx - 1


def _k2_check(torch, fused_step, got, ref, idx, layer, pos, parity, rows, what) -> None:
    """``ref`` (a copy of the planes before ``got``'s call) through the
    plain version at ``pos``, then K2's contract against ``got``."""
    fused_step.permute_append_reference(*ref, idx, layer, pos, parity, *rows)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        if not _k2_contract_equal(torch, a, b, layer, pos, parity):
            fail(f"K2 {what} differs from its plain version at pos {pos} parity {parity}")


def k2_device_position(torch, fused_step, gen) -> dict:
    """K2 reading its position from an int64 on the card, as a captured
    decode step launches it, at the flagship's planes (fp8, new rows in
    bf16): launched directly at pos 0, 1, 113, 226 and 227 and both
    parities, then replayed from two captured graphs (one per read parity,
    one memory pool, one set of planes, each advancing the position as a
    decode step does) at the positions of ``DEVICE_POS_RUNS``, parities
    alternating; each call bitwise against the plain version at the same
    position. One kernel per call, launched and replayed (profiler);
    timed at pos 35 and 200 beside the launch-argument form."""
    from torch.profiler import ProfilerActivity, profile

    _, n_layer, bk, ctx, hd = FLAGSHIP_PLANES
    idx = torch.randint(0, bk, (bk,), generator=gen, device="cuda", dtype=torch.int32)
    idx[1] = idx[0]  # beam branching: a duplicate, always
    layer = n_layer - 1
    planes = [(4 * torch.randn(FLAGSHIP_PLANES, generator=gen, device="cuda")).to(getattr(torch, FP8))
              for _ in range(2)]
    rows = [r.to(torch.bfloat16) for r in (torch.randn((bk, hd), generator=gen, device="cuda")
                                          for _ in range(2))]
    at = torch.zeros((1,), dtype=torch.int64, device="cuda")
    for pos in (0, 1, 113, ctx - 2, ctx - 1):
        for parity in (0, 1):
            at.fill_(pos)
            ref = [p.clone() for p in planes]
            fused_step.permute_append(*planes, idx, layer, at, parity, *rows)
            _k2_check(torch, fused_step, planes, ref, idx, layer, pos, parity, rows, "launched")
    names = kernels_per_call(torch, lambda: fused_step.permute_append(*planes, idx, layer, at, 0, *rows))
    if len(names) != 1 or fused_step.KERNEL_SYMBOL not in names[0]:
        fail(f"K2 with a device position launched {names}, expected its one kernel")

    graphs, pool = [], torch.cuda.graph_pool_handle()
    for parity in (0, 1):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            fused_step.permute_append(*planes, idx, layer, at, parity, *rows)
            at.add_(1)
        graphs.append(g)
    step = 0
    for first, n in DEVICE_POS_RUNS:
        at.fill_(first)
        for pos in range(first, first + n):
            parity = step % 2
            ref = [p.clone() for p in planes]
            graphs[parity].replay()
            _k2_check(torch, fused_step, planes, ref, idx, layer, pos, parity, rows, "replayed")
            if int(at.item()) != pos + 1:
                fail(f"K2's graph left the position at {int(at.item())}, expected {pos + 1}")
            step += 1
    at.fill_(35)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graphs[0].replay()
        torch.cuda.synchronize()
    replayed = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and fused_step.KERNEL_SYMBOL in e.name]
    if len(replayed) != 1:
        fail(f"a replay of K2's graph ran {replayed} in a profiler trace, expected its one kernel")

    times = {}
    for pos in (35, 200):
        at.fill_(pos)
        times[pos] = (
            time_ms(lambda: fused_step.permute_append(*planes, idx, layer, at, 0, *rows)),
            time_ms(lambda: fused_step.permute_append(*planes, idx, layer, pos, 0, *rows)),
        )
    log(
        f"  K2 {list(FLAGSHIP_PLANES)} {FP8}, device position, bf16 rows: bitwise equal launched "
        f"(pos 0, 1, 113, {ctx - 2}, {ctx - 1}; both parities) and replayed from two graphs at "
        f"{step} positions ({', '.join(f'{a}–{a + n - 1}' for a, n in DEVICE_POS_RUNS)}, parities "
        f"alternating); one kernel per call, launched and replayed; "
        + "; ".join(f"pos {p}: {d:.4f} ms, with pos as a launch argument {i:.4f} ms"
                    for p, (d, i) in times.items())
    )
    return {"shape": list(FLAGSHIP_PLANES), "replayed_positions": step,
            "ms": {str(p): d for p, (d, _) in times.items()},
            "launch_argument_ms": {str(p): i for p, (_, i) in times.items()}}


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
    record["device_position"] = k2_device_position(torch, fused_step, gen)
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
    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    args = dict(model="large-v3", batch=4, beam=5, ctx=68, kv=FP8)
    k3_launches = None
    for mode in probe_fused.MODES:
        reset_counts(*kernels)  # counts start here: this mode's run
        res = probe_fused.run(**args, iters=8, warmup=1, mode=mode)
        torch.cuda.synchronize()
        k3, k2 = gather_attend.launches, fused_step.launches
        others = (attention.launches + gather.launches + mel_fused.launches
                  + fused_step.sharded_launches + fp8_upcast.launches)  # counts end here
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


PROBE_CROSS_ITERS = 16  # phase 4g: JAX's default iterations


def _upcast_equal(torch, got, want) -> bool:
    """K6's contract: bits equal where the value is not NaN, NaN where it is."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan]))


def phase_fp8_upcast(torch, fp8_upcast) -> dict:
    """K6 against its plain version, bitwise (NaN codes NaN): all 256 codes
    of float8_e4m3fn and float8_e5m2, one layer's plane of the probe's
    defaults [B·H·Dh, Tk] = [20480, 1500] (the record), counts that are not
    a multiple of 16, one row; a sliced view and a misaligned base refused;
    one device kernel per call (profiler). Times the kernel, the plain
    version and the library call (``.to(torch.bfloat16)``, which is also
    the plain version's body) beside the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    codes = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
    cases = [(f"all 256 codes, {dt}", codes.view(getattr(torch, dt))) for dt in (FP8, "float8_e5m2")]
    plane = torch.randn((20480, 1500), generator=gen, device="cuda", dtype=torch.bfloat16).to(getattr(torch, FP8))
    cases.append(("the probe's plane [20480, 1500]", plane))
    for shape in ((1000003,), (3, 5, 7), (1, 1500)):
        x = torch.randn(shape, generator=gen, device="cuda").mul(64).to(getattr(torch, FP8))
        cases.append((f"{list(shape)} ({x.numel() % 16} past the last 16)", x))
    for label, x in cases:
        before = fp8_upcast.launches
        got = fp8_upcast.dma_upcast(x)
        torch.cuda.synchronize()
        want = fp8_upcast.dma_upcast_reference(x)
        if fp8_upcast.launches != before + 1 or not _upcast_equal(torch, got, want):
            fail(f"K6 differs from its plain version (or did not count its launch): {label}")
        log(f"  K6 {label}: bitwise equal ({int(torch.isnan(want).sum())} NaN codes NaN)")
    for label, bad in (("a sliced view", plane[:, 1:]), ("a base 1 byte past 16", plane.reshape(-1)[1:])):
        try:
            fp8_upcast.dma_upcast(bad)
            fail(f"K6 took {label}")
        except ValueError as e:
            log(f"  K6 refuses {label}: {e}")
    names = kernels_per_call(torch, lambda: fp8_upcast.dma_upcast(plane))
    if len(names) != 1 or fp8_upcast.KERNEL_SYMBOL not in names[0]:
        fail(f"K6: one call launched {names}")
    err = (fp8_upcast.dma_upcast(plane).float() - plane.float()).abs().max().item()
    kern_ms = time_ms(lambda: fp8_upcast.dma_upcast(plane))
    plain_ms = time_ms(lambda: fp8_upcast.dma_upcast_reference(plane))
    lib_ms = time_ms(lambda: plane.to(torch.bfloat16))
    bound = bytes_bound_ms(plane.numel() * 3)  # fp8 read once, bf16 written once
    log(f"  K6 [20480, 1500] {FP8}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f".to(torch.bfloat16) {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes: 92.16 MB); "
        f"one kernel per call ({names[0]})")
    return {
        "name": "fp8_upcast", "route": "cuda", "source": "whisper_tpu_torch/csrc/fp8_upcast.cu",
        "replaces": "tools/probe_cross.py:119", "launches": None, "max_abs_err": err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
        "shape": [20480, 1500], "dtype": FP8,
    }


def phase_probe_cross(torch, kernels, probe_cross) -> dict:
    """K6's path at full width (docstring, phase 4g): ``probe_cross.run`` at
    JAX's defaults in each mode, launches counted per mode; then at turbo's
    shape (beam 1, a bf16 store) in "bf16" and "kernel". Returns K6's
    launches under "dmastage", each mode's record and the turbo leg's."""
    from whisper_tpu_torch.ops import cross_attend

    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    torch.backends.cuda.matmul.allow_tf32 = False  # the probe's f32 products in f32, torch's default
    args = dict(model="large-v3", batch=16, tk=1500, iters=PROBE_CROSS_ITERS, warmup=1)
    out = {}
    for leg, beam, kv, modes, plain in (("flagship", 5, FP8, probe_cross.MODES, "prod"),
                                        ("turbo", 1, "bfloat16", ("bf16", "kernel"), "bf16")):
        qs, records = {}, {}
        for mode in modes:
            torch.cuda.synchronize()
            reset_counts(*kernels, cross_attend)  # counts start here: this mode's run
            res = probe_cross.run(**args, beam=beam, kv=kv, mode=mode)
            torch.cuda.synchronize()
            n = {"K1": attention.launches, "K2": fused_step.launches, "K2′": fused_step.sharded_launches,
                 "K3": gather_attend.launches, "K4": gather.launches, "K5": mel_fused.launches,
                 "K6": fp8_upcast.launches, "cross": cross_attend.launches}  # counts end here
            rec = dict(probe_cross.record(mode, res), launches=n)
            log(f"  {leg} {mode}: {rec['ms_per_iter']:.4f} ms per {res['layers']}-layer iteration "
                f"(events; {rec['device_ms_per_iter']:.4f} device ms of its kernels), "
                f"{rec['gb_per_s']:.0f} GB/s of its {rec['gb']:.3f} GB window read; moves "
                f"{rec['moved_gb']:.3f} GB by its ops ({rec['moved_gb'] / rec['ms_per_iter'] * 1e3:.0f} GB/s); "
                f"fp8 window bound {rec['bound_ms']:.4f} ms ({rec['bound_ms'] / rec['ms_per_iter']:.3f} of "
                f"the time); {rec['launches_per_iter']} device launches per iteration; launches {n}")
            for name, k in (rec["top_kernels"] or {}).items():
                log(f"    {k['ms']:8.3f} device ms in {k['count']:4d} launches of {name[:240]}")
            want = {"K6": 2 * LARGE_V3_DEC_LAYERS * res["steps"]} if mode == "dmastage" else (
                {"cross": LARGE_V3_DEC_LAYERS * res["steps"]} if mode == "kernel" else {})
            if n != dict.fromkeys(n, 0) | want or res["layers"] != LARGE_V3_DEC_LAYERS:
                fail(f"4g {leg} {mode}: launches {n}, expected {want} and nothing else")
            if not bool(torch.isfinite(res["q"].float()).all()):
                fail(f"4g {leg} {mode}: q not finite")
            qs[mode], records[mode] = res["q"], rec
        for mode in ("stage", "dmastage"):
            if mode in qs and not torch.equal(qs[mode], qs[plain]):
                fail(f"4g {leg}: {mode}'s q is not bitwise equal to {plain}'s")
        tol = bf16_tolerance(qs[plain].float().abs().max().item())
        for mode in ("chunk", "kernel"):
            if mode not in qs:
                continue
            err = (qs[mode].float() - qs[plain].float()).abs().max().item()
            log(f"  {leg}: {mode} against {plain}: max_abs_err {err:.3g} (tol {tol:.3g}: 4 bf16 ulps at "
                f"max|q|, each rounds its softmax weights at another place)")
            if err > tol:
                fail(f"4g {leg}: {mode}'s q is {err:.3g} from {plain}'s, tol {tol:.3g}")
        out[leg] = records
    log("  flagship: q of prod, stage and dmastage bitwise equal")
    return {"k6_launches": out["flagship"]["dmastage"]["launches"]["K6"], "records": out["flagship"],
            "turbo": out["turbo"]}


CROSS_CASES = (  # phase 13a: (label, rows, queries a row, heads, Tk, store)
    ("flagship step", 16, 5, 20, 1500, "float8_e4m3fn"),
    ("turbo step", 16, 1, 20, 1500, "bfloat16"),
    ("flagship prefill, beam x a 4-token prompt", 16, 20, 20, 1500, "float8_e4m3fn"),
    ("tensor-parallel rank's step", 16, 5, 10, 1500, "float8_e4m3fn"),
    ("crop 512, e5m2", 16, 5, 20, 512, "float8_e5m2"),
)
CROSS_BEAM_BUDGET = 32  # phase 13b: new tokens a row of the replayed flagship decode


def cross_bound_ms(b: int, tq: int, h: int, tk: int, itemsize: int) -> float:
    """Bytes of one layer's cross read over the card's rate: K and V in
    their stored type, q and the output in bf16, each once."""
    return (2 * b * h * 64 * tk * itemsize + 2 * b * tq * h * 64 * 2) / PEAK_BYTES * 1e3


def phase_cross_attend(torch, cross_attend) -> dict:
    """Phase 13a: the cross-attention kernel against its plain version on the
    same card tensors at the cells' shapes (:data:`CROSS_CASES`), within 2
    bf16 ulps of the output's largest magnitude, one launch a call; the
    kernel's, the plain version's and the bound's ms (a layer)."""
    out = {}
    for label, b, tq, h, tk, store in CROSS_CASES:
        gen = torch.Generator(device="cuda").manual_seed(tq * tk + h)
        dt = getattr(torch, store)
        q = torch.randn((b, tq, h, 64), generator=gen, device="cuda").to(torch.bfloat16)
        kT, vT = ((2.0 * torch.randn((b, h, 64, tk), generator=gen, device="cuda")).to(dt) for _ in range(2))
        before = cross_attend.launches
        got = cross_attend.cross_attend(q, kT, vT)
        torch.cuda.synchronize()
        if cross_attend.launches != before + 1:
            fail(f"13a {label}: {cross_attend.launches - before} launches for one call")
        want = cross_attend.cross_attend_reference(q, kT, vT)
        ref_max = want.float().abs().max().item()
        tol = bf16_tolerance(ref_max) / 2  # 2 bf16 ulps
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"13a {label}: max_abs_err {err:.3g} against the plain version, tol {tol:.3g}")
        plan = cross_attend.plan(tq, tk, dt.itemsize, kT.data_ptr(), vT.data_ptr())
        kernel_ms = time_ms(lambda: cross_attend.cross_attend(q, kT, vT))
        plain_ms = time_ms(lambda: cross_attend.cross_attend_reference(q, kT, vT), inner=5)
        host_ms = host_ms_per_call(lambda: cross_attend.cross_attend(q, kT, vT))
        plain_host_ms = host_ms_per_call(lambda: cross_attend.cross_attend_reference(q, kT, vT), calls=20)
        bound = cross_bound_ms(b, tq, h, tk, dt.itemsize)
        rec = {"shape": [b, tq, h, 64, tk], "store": store, "plan": plan._asdict(), "max_abs_err": err,
               "tol": tol, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
               "roofline": bound / kernel_ms, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
               **cross_library(torch, q, kT, vT, want)}
        out[label] = rec
        lib = ("no library call reads an fp8 store" if rec["library_ms"] is None else
               f"SDPA {rec['library_ms']:.4f} ms on the stored layout, {rec['library_copied_ms']:.4f} ms with "
               f"K and V copied to [B, H, Tk, 64] first (max_abs_err {rec['library_err']:.3g})")
        log(f"  {label} [{b},{tq},{h},64,{tk}] {store}: kernel {kernel_ms:.4f} ms, bound {bound:.4f} ms "
            f"(bytes; {100 * bound / kernel_ms:.1f}%), plain {plain_ms:.4f} ms, {lib}; host {host_ms:.4f} ms "
            f"a call (plain {plain_host_ms:.4f}); max_abs_err {err:.3g} (tol {tol:.3g}); plan {tuple(plan)}")
    return out


def cross_library(torch, q, kT, vT, want) -> dict:
    """The library's one call for the same function where there is one: on
    a bf16 store, ``F.scaled_dot_product_attention`` on the stored layout's
    transposes (whichever backend torch picks for K and V whose last axis
    is not contiguous), and on K and V copied to [B, H, Tk, 64] first (the
    copy timed in); the port never calls it. Its distance from the plain
    version is printed, not held to a tolerance (it rounds the scores to
    bf16). Nothing on an fp8 store: no one call reads it."""
    import torch.nn.functional as F

    if kT.dtype != torch.bfloat16:
        return {"library_ms": None, "library_copied_ms": None, "library_err": None}
    qt = q.transpose(1, 2)

    def stored():
        return F.scaled_dot_product_attention(qt, kT.transpose(-1, -2), vT.transpose(-1, -2))

    def copied():
        return F.scaled_dot_product_attention(qt, kT.transpose(-1, -2).contiguous(),
                                              vT.transpose(-1, -2).contiguous())

    err = (stored().transpose(1, 2).float() - want.float()).abs().max().item()
    return {"library_ms": time_ms(stored, inner=5), "library_copied_ms": time_ms(copied, inner=5),
            "library_err": err}


def phase_cross_replayed(torch, cross_attend) -> dict:
    """Phase 13b: the flagship's decode at large-v3 width (random weights,
    int8, an fp8 cache, beam 5, "hybrid", 16 rows of 1500 encoder positions,
    a 4-token prompt) with its steps replayed from captured graphs, twice on
    one ``StepGraphs``: ``launches`` must rise by 32 for the prefill and for
    every step, replays included; the second run, every step of it
    replayed, under the profiler, whose ``cross_attend`` kernels must equal
    that run's count. Each run's launches equal its witnessed layers
    (:data:`CROSS`)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.config import MODEL_DIMS
    from whisper_tpu_torch.decode import beam, graph
    from whisper_tpu_torch.models.params import init_params
    from whisper_tpu_torch.models.quantize import quantize_params

    dims = dataclasses.replace(MODEL_DIMS["large-v3"])
    params = quantize_params(init_params(dims, torch.Generator("cuda").manual_seed(13),
                                         dtype=torch.bfloat16, device="cuda"))
    gen = torch.Generator("cuda").manual_seed(14)
    enc = torch.randn((16, dims.n_audio_ctx, dims.n_audio_state), generator=gen, device="cuda")
    enc = enc.to(torch.bfloat16)
    prompt = torch.tensor([[50258, 50259, 50360, 50364]] * 16, device="cuda")
    kw = dict(dims=dims, eot=50257, max_new_tokens=CROSS_BEAM_BUDGET, beam_size=5,
              compute_dtype=torch.bfloat16, kv_cache_dtype=torch.float8_e4m3fn, fused="hybrid",
              graphs=graph.StepGraphs())
    out = {}
    for traced in (False, True):
        torch.cuda.synchronize()
        n0, s0, r0, w0 = cross_attend.launches, beam.steps, graph.replays, CROSS.layers
        t0 = time.perf_counter()
        if traced:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                beam.beam_decode(params, enc, prompt, **kw)
                torch.cuda.synchronize()
        else:
            beam.beam_decode(params, enc, prompt, **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, steps, replays = cross_attend.launches - n0, beam.steps - s0, graph.replays - r0
        if n != LARGE_V3_DEC_LAYERS * (1 + steps) or CROSS.layers - w0 != n:
            fail(f"13b: {n} cross_attend launches for a prefill and {steps} steps, "
                 f"{CROSS.layers - w0} decoder layers witnessed")
        rec = {"launches": n, "steps": steps, "replays": replays, "wall_s": wall}
        if traced:
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.name.startswith(cross_attend.KERNEL_SYMBOL)]
            if len(kernels) != n:
                fail(f"13b: {len(kernels)} cross_attend kernels in the trace, {n} counted")
            rec["traced_kernels"] = len(kernels)
            rec["traced_kernel_ms"] = sum(e.device_time_total for e in kernels) / 1e3
            if replays != steps:
                fail(f"13b: {replays} of {steps} steps of the second decode replayed")
        out["traced" if traced else "untraced"] = rec
        log(f"  flagship decode {'traced' if traced else 'untraced'}: {wall:.2f} s, {steps} steps "
            f"({replays} replayed), cross_attend launches {n}"
            + (f" = {rec['traced_kernels']} kernels in the trace, {rec['traced_kernel_ms']:.2f} device ms"
               if traced else ""))
    del params
    return out


def phase_cross(torch, cross_attend) -> dict:
    log("[13a] the cross-attention kernel against its plain version, timed beside its bound")
    rec = {"cases": phase_cross_attend(torch, cross_attend)}
    log("[13b] the flagship's decode at large-v3 width, its steps replayed: launches against a trace")
    rec["replayed"] = phase_cross_replayed(torch, cross_attend)
    return rec


def cross_kernel_record(cross_rec, greedy, flagship, dp, tp, stream, serving, probe) -> dict:
    """The cross-attention kernel's entry of the ``kernels`` line: phase
    13a's times at the flagship's step (and every case's), and its launches
    on each path that ran it, beside their witnesses."""
    step = cross_rec["cases"]["flagship step"]
    keys = ("shape", "store", "kernel_ms", "bound_ms", "plain_ms", "library_ms", "library_copied_ms", "roofline")
    return {
        "name": "cross_attend", "route": "cuda", "source": "whisper_tpu_torch/csrc/cross_attend.cu",
        "replaces": "whisper_tpu/models/layers.py:cross_attention_T (two einsums XLA fuses)",
        "launches": flagship["run"]["cross"], "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": "bytes", "library_ms": step["library_ms"],
        "shape": step["shape"], "dtype": step["store"],
        "cases": {label: {k: c[k] for k in keys} for label, c in cross_rec["cases"].items()},
        "engine_launches": {"greedy": greedy["run"], "beam": flagship["run"], "beam_off": flagship["off"]},
        "engine_traced": {"greedy": greedy["traced"], "beam": flagship["traced"]},
        "replayed_decode": cross_rec["replayed"],
        "dp_launches_per_rank": dp,
        "tp_launches_per_rank": {label: rec["cross_per_rank"] for label, rec in tp.items()},
        "stream_launches": {label: r["launches"]["cross"] for label, r in stream.items()},
        "serving_launches": {name: rec["cross"] for name, rec in serving.items()},
        "probe": {leg: {mode: {k: r[k] for k in ("ms_per_iter", "device_ms_per_iter", "launches_per_iter")}
                        | {"launches": r["launches"]["cross"]} for mode, r in recs.items()}
                  for leg, recs in (("flagship", probe["records"]), ("turbo", probe["turbo"]))},
    }


def cross_only() -> None:
    """``--cross``: phases 1, 2 (the cross-attention kernel only) and 13; the
    last line is phase 13's JSON record."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from whisper_tpu_torch.ops import build, cross_attend

    CROSS.install()
    log(f"[1] card: {card_line()}")
    t0 = time.perf_counter()
    for name, (secs, ptxas) in build.build([cross_attend.KERNEL]).items():
        usage = [ln.strip() for ln in ptxas.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        log(f"[2] {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    print(json.dumps(phase_cross(torch, cross_attend)))


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


def roofline_line(torch, engine, results, wall: float, host: np.ndarray) -> dict:
    """``utils/roofline.utilization`` of one timed ``transcribe_batch``
    (the card's peaks; the decode's mean generated tokens per row; the
    port's one preallocated cache, so no segment growth), logged."""
    from whisper_tpu_torch.utils import roofline

    cfg = engine.config
    p_len = len(engine._prompt)
    new = float(np.mean([r.length - p_len for r in results]))
    u = roofline.utilization(
        engine.dims, len(results), cfg.beam_size, p_len, new, p_len + engine._max_new, wall,
        cfg.quantization, cfg.kv_cache_dtype, torch.cuda.get_device_name(0), ctx_bucket=None,
        audio_ctx=engine._resolve_audio_ctx(host),
    )
    log(f"  roofline (utils/roofline.py at {u.get('chip')}'s peaks): mfu {u.get('mfu')}, hbm_utilization "
        f"{u.get('hbm_utilization')}, sol_decode_s {u.get('sol_decode_s')} (analytic "
        f"{u['analytic_tflops']} TFLOP, {u['decode_gb_streamed']} GB streamed by the decode, "
        f"{new:.1f} tokens per row)")
    return u


class CrossWitness:
    """The decoder forwards that run on the card in bf16, and their layers,
    counted apart from the cross-attention kernel: a spy on
    ``models/decoder._layers`` (every decoder forward of every step mode
    goes through it) counts each call whose input is a bf16 card tensor,
    worth its layers; a captured step counts nothing at its capture and
    what its capture saw at each replay (spies on ``decode/graph.Entry``).
    Every such layer must be one launch of the kernel: ``launches`` of
    ``ops/cross_attend`` equals :attr:`layers` (32 × :attr:`forwards` on
    large-v3), and f32 forwards count and launch nothing."""

    def __init__(self):
        self.forwards = self.layers = 0
        self.module = None  # ops/cross_attend, once installed

    def install(self) -> "CrossWitness":
        import torch

        from whisper_tpu_torch.decode import graph
        from whisper_tpu_torch.models import decoder
        from whisper_tpu_torch.ops import cross_attend

        if self.module is not None:
            return self
        self.module = cross_attend
        forward, capture, step = decoder._layers, graph.Entry._capture, graph.Entry.step

        def layers_spy(dec, x, *args, **kw):
            if x.is_cuda and x.dtype == torch.bfloat16:
                self.forwards += 1
                self.layers += len(dec["blocks"])
            return forward(dec, x, *args, **kw)

        def capture_spy(entry, run, variant):
            before = self.forwards, self.layers
            capture(entry, run, variant)
            seen = (self.forwards - before[0], self.layers - before[1])
            entry.__dict__.setdefault("witnessed", {})[variant] = seen
            self.forwards, self.layers = before  # a capture runs nothing on the card

        def step_spy(entry, run, variant):
            replayed = step(entry, run, variant)
            if replayed:
                f, n = entry.witnessed[variant]
                self.forwards += f
                self.layers += n
            return replayed

        decoder._layers, graph.Entry._capture, graph.Entry.step = layers_spy, capture_spy, step_spy
        return self

    def reset(self) -> None:
        self.forwards = self.layers = 0
        if self.module is not None:
            self.module.launches = 0

    def counts(self) -> dict:
        """The kernel's launches, the bf16 decoder forwards and their layers."""
        return {"cross": self.module.launches, "decoder_forwards": self.forwards, "cross_reads": self.layers}


CROSS = CrossWitness()  # installed by main() and cross_only(), and in the CLI's processes


def reset_counts(*modules) -> None:
    """Every launch count of ``modules``, and the cross-attention kernel's
    with its witness (:data:`CROSS`), set to 0."""
    for m in modules:
        m.launches = 0
        if hasattr(m, "sharded_launches"):  # K2′ counts beside K2 in ops/fused_step.py
            m.sharded_launches = 0
    CROSS.reset()


def check_cross(label: str, n: dict, bf16: bool = True, want: int = None) -> None:
    """The cross-attention kernel's launches ``n["cross"]`` against its
    witness's layers (``want`` where the phase also reads the cross
    attention outside a decoder forward): equal, and above 0 on a bf16
    path."""
    want = n["cross_reads"] if want is None else want
    if n["cross"] != want or (bf16 and want == 0):
        fail(f"{label}: the cross-attention kernel launched {n['cross']} times, expected {want} "
             f"(bf16 decoder forwards {n['decoder_forwards']}, their layers {n['cross_reads']})")


CROSS_TRACED_BUDGET = 16  # tokens a row of phases 4's and 4b's traced transcribe_batch
CROSS_TRACES = 3  # traced runs at most, until one holds every counted kernel


def cross_traced(torch, label: str, engine, batch) -> dict:
    """``transcribe_batch`` of ``batch`` on ``engine``'s weights at a budget
    of :data:`CROSS_TRACED_BUDGET` tokens, once to capture its steps and
    then under the profiler, its counts set to 0 just before each: the
    kernel's launches and its witness's layers must be equal and above 0,
    and the ``cross_attend*`` kernels of the trace equal to them. A trace
    can lose kernels, never gain them: the profiler drops buffers of
    records under the replayed steps' pace (in a full smoke one trace of a
    64-token greedy batch lost 28 of 2,080 ``cross_attend`` kernels, one
    of a 16-token flagship batch 7 of 544, while a run alone kept all), so
    a trace short of the count is taken again, up to :data:`CROSS_TRACES`
    times, and one that holds more fails at once. The run starts
    ``TRACE_PAD_S`` after the profiler and ends as long before it stops
    (``utils/probe_cross.traced_step``: kernels near a trace's edges can
    fall outside its window)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.utils.probe_cross import TRACE_PAD_S

    short = _engine_with(engine, max_new_tokens=CROSS_TRACED_BUDGET)
    short.transcribe_batch(batch)  # its steps captured
    short_of = []
    for _ in range(CROSS_TRACES):
        torch.cuda.synchronize()
        CROSS.reset()  # counts start here
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            short.transcribe_batch(batch)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        n = CROSS.counts()  # counts end here
        check_cross(f"{label} traced", n)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device if e.name.startswith(CROSS.module.KERNEL_SYMBOL)]
        if len(kernels) > n["cross"]:
            fail(f"{label} traced: {len(kernels)} cross_attend kernels in the trace, {n['cross']} counted")
        if len(kernels) == n["cross"]:
            break
        short_of.append(n["cross"] - len(kernels))
        log(f"  {label} traced: {len(kernels)} cross_attend kernels in a trace of {len(device)}, "
            f"{n['cross']} counted: records dropped, traced again")
    else:
        fail(f"{label} traced: every trace short of the {n['cross']} counted cross_attend kernels by {short_of}")
    rec = dict(n, traced_kernels=len(kernels), trace_kernels=len(device), traces_short_by=short_of,
               traced_kernel_ms=sum(e.device_time_total for e in kernels) / 1e3)
    log(f"  {label} traced ({CROSS_TRACED_BUDGET} tokens a row): cross_attend launches {n['cross']} = "
        f"{len(kernels)} kernels in the trace of {len(device)} ({rec['traced_kernel_ms']:.2f} device ms) = "
        f"{n['cross_reads'] // max(n['decoder_forwards'], 1)} × {n['decoder_forwards']} bf16 decoder forwards")
    # The short engine's graphs are freed here: left to the collector, one was reset during a later
    # engine's capture, which that invalidates.
    del short, prof
    gc.collect()
    torch.cuda.synchronize()
    return rec


def phase_main_path(torch, kernels, EngineConfig, EngineType, create_engine) -> tuple:
    """Greedy main path (docstring, phase 4). Returns K1's launches, the
    engine, its batch's results and the cross-attention kernel's counts."""
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
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
    launches, cross = attention.launches, CROSS.counts()  # counts end here
    others = (fused_step.launches, gather.launches, gather_attend.launches, mel_fused.launches,
              fused_step.sharded_launches, fp8_upcast.launches)
    if any(others):
        fail(f"greedy launched K2, K4, K3, K5, K2′, K6 {others} times, expected none")
    check_cross("4 greedy", cross)

    log(
        f"  large-v3 bf16, batch 4 ({audio_s:.1f} s of audio): {wall * 1e3:.1f} ms "
        f"→ {audio_s / wall:.2f} audio-s/s; mel+encoder {(t1 - t0) * 1e3:.1f} ms, "
        f"decode {(t2 - t1) * 1e3:.1f} ms over {steps} steps "
        f"= {(t2 - t1) * 1e3 / max(steps, 1):.2f} ms/token"
    )
    roofline_line(torch, engine, results, wall, host)
    for r in results:
        log(f"    lang {r.language} length {r.length} tokens {r.tokens[:8].tolist()}...")
    log(f"    file: lang {single.language} length {single.length}")
    expected = LARGE_V3_ENC_LAYERS * encodes
    log(f"  K1 launches on the main path: {launches} ({encodes} encodes × {dims.n_audio_layer} layers); "
        f"cross_attend {cross['cross']} ({cross['decoder_forwards']} bf16 decoder forwards × "
        f"{dims.n_text_layer} layers)")
    if dims.n_audio_layer != LARGE_V3_ENC_LAYERS or launches != expected:
        fail(f"K1 launched {launches} times, expected {expected}")
    cross = {"run": cross, "traced": cross_traced(torch, "4 greedy transcribe_batch", engine, batch)}
    return launches, engine, results, cross


def phase_beam_path(torch, kernels, beam, EngineConfig, EngineType, create_engine) -> tuple:
    """Beam main path (docstring, phase 4b). Returns the K2 and K4 launch
    counts of their runs, the hybrid engine, its batch's results and the
    cross-attention kernel's counts."""
    from whisper_tpu_torch.audio.wav import write_wav

    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
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
    k6, cross = fp8_upcast.launches, CROSS.counts()  # counts end here

    log(
        f"  large-v3 beam 5 int8 + fp8 KV, batch 4 ({audio_s:.1f} s of audio): "
        f"{wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; mel+encoder "
        f"{(t1 - t0) * 1e3:.1f} ms, decode {(t2 - t1) * 1e3:.1f} ms over {stage_steps} "
        f"steps = {(t2 - t1) * 1e3 / max(stage_steps, 1):.2f} ms/step"
    )
    roofline_line(torch, engine, results, wall, host)
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
    if k3 or k5 or k2s or k6:
        fail(f"hybrid: K3 launched {k3} times, K5 {k5}, K2′ {k2s}, K6 {k6}, expected none")
    if k2 != LARGE_V3_DEC_LAYERS * steps or k4 != 0:
        fail(f"hybrid: K2 launched {k2} times (expected {LARGE_V3_DEC_LAYERS * steps}), K4 {k4} (expected 0)")
    check_cross("4b hybrid", cross)
    log(f"  cross_attend {cross['cross']} ({cross['decoder_forwards']} bf16 decoder forwards × "
        f"{dims.n_text_layer} layers: detection, prefill and {steps} beam steps over {encodes} decodes)")
    k2_on_card(torch, fused_step, beam, engine, enc_out)
    cross = {"run": cross, "traced": cross_traced(torch, "4b flagship transcribe_batch", engine, batch)}

    # The same weights with the eager step and the K4 reorder.
    off = type(engine)(engine.assets, dataclasses.replace(cfg, fused_step="off"), device="cuda")
    reset_counts(*kernels)  # counts start here: the "off" run
    beam.steps = 0
    t0 = time.perf_counter()
    results_off = off.transcribe_batch(batch)
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t0
    k2_off, k4_off, steps_off = fused_step.launches, gather.launches, beam.steps
    k35_off = gather_attend.launches + mel_fused.launches + fp8_upcast.launches
    cross["off"] = CROSS.counts()  # counts end here
    log(
        f"  fused_step='off': {wall_off * 1e3:.1f} ms → {audio_s / wall_off:.2f} audio-s/s; "
        f"K2 {k2_off}, K4 {k4_off} ({steps_off} steps × 2)"
    )
    if k2_off != 0 or k35_off != 0 or k4_off != 2 * steps_off or steps_off == 0:
        fail(f"off: K2 launched {k2_off} times (expected 0), K4 {k4_off} (expected {2 * steps_off})")
    check_cross("4b off", cross["off"])
    for a, b in zip(results, results_off):
        if not np.array_equal(a.tokens, b.tokens) or a.length != b.length:
            fail(f"hybrid and off tokens differ: {a.tokens[:a.length].tolist()} vs {b.tokens[:b.length].tolist()}")
    log("  hybrid and off tokens equal")
    return k2, k4_off, engine, results, cross


def k2_on_card(torch, fused_step, beam, engine, enc_out) -> None:
    """K2's kernels on the card in one more decode of the stage's encoder
    output, whose steps are replays of captured graphs: counted from a
    profiler trace, they must be one per decoder layer and step, as
    ``fused_step.launches`` counts them."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.decode import graph

    steps0, replays0, k2_0 = beam.steps, graph.replays, fused_step.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine._decode(enc_out)
        torch.cuda.synchronize()
    steps, replays, counted = beam.steps - steps0, graph.replays - replays0, fused_step.launches - k2_0
    on_card = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and fused_step.KERNEL_SYMBOL in e.name)
    log(f"  profiled decode: {steps} steps, {replays} of them replayed; K2 kernels in the trace "
        f"{on_card}, counted {counted} ({steps} steps × {LARGE_V3_DEC_LAYERS} layers)")
    if steps == 0 or replays != steps:
        fail(f"the profiled decode replayed {replays} of its {steps} steps, expected every one")
    if on_card != LARGE_V3_DEC_LAYERS * steps or counted != on_card:
        fail(f"K2 ran {on_card} times on the card and was counted {counted} times, "
             f"expected {LARGE_V3_DEC_LAYERS * steps}")


def phase_quantize_witness(torch, main_engine, beam_engine) -> None:
    """Phase 4b's witness of the int8 quantisation: ``quantize_params`` of
    phase 4's tree on the card equals the same call on the host bitwise,
    leaf by leaf (each divide takes a divisor on the device: see
    ``models/quantize.py``), and the flagship engine's own tree (quantised
    on the card at construction from the same seed) equals both."""
    from whisper_tpu_torch.models.params import leaves, to_device
    from whisper_tpu_torch.models.quantize import quantize_params

    t0 = time.perf_counter()
    on_card = list(leaves(quantize_params(main_engine.assets.params)))
    on_host = list(leaves(quantize_params(to_device(main_engine.assets.params, "cpu"))))
    flagship = list(leaves(beam_engine.assets.params))
    if not len(on_card) == len(on_host) == len(flagship):
        fail(f"4b: {len(on_card)} leaves quantised on the card, {len(on_host)} on the host, "
             f"{len(flagship)} in the flagship engine")
    for i, (c, h, f) in enumerate(zip(on_card, on_host, flagship)):
        if not (torch.equal(c.cpu(), h) and torch.equal(c, f)):
            fail(f"4b: quantised leaf {i} ({c.dtype}, {list(c.shape)}) differs between the card, the host "
                 f"and the flagship engine")
    n = sum(x.numel() for x in on_card)
    log(f"  quantize_params of phase 4's tree: card == host == the flagship engine's tree, bitwise, "
        f"{len(on_card)} leaves, {n} values ({time.perf_counter() - t0:.1f} s)")


def phase_data_parallel(torch, beam_engine, beam_results) -> list:
    """The flagship data-parallel path (docstring, phase 4d). Returns K2′'s
    and the cross-attention kernel's launches on each rank."""
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
    k2s, cross = [], []
    for rep in reports:
        run = rep["runs"]["auto"]
        n, steps = run["launches"], run["steps"]
        rows_s = sum(LENGTHS_S[2 * rep["rank"]: 2 * rep["rank"] + 2])
        log(f"  rank {rep['rank']} of {rep['world']} on {rep['device']} ({rep['device_name']}): "
            f"{run['seconds'] * 1e3:.1f} ms for its 2 rows ({rows_s:.1f} s of audio) → "
            f"{rows_s / run['seconds']:.2f} audio-s/s; launches K1 {n['flash_attn_fwd']}, "
            f"K2 {n['permute_append']}, K2′ {n['permute_append_sharded']} ({steps} steps × "
            f"{LARGE_V3_DEC_LAYERS} layers), K4 {n['permute_rows']}, cross_attend {n['cross_attend']}; "
            f"weights checksum {rep['params_checksum']}")
        if rep["params_checksum"] != checksum:
            fail(f"rank {rep['rank']} holds other weights than phase 4b: {rep['params_checksum']} != {checksum}")
        if steps == 0 or n["permute_append_sharded"] != LARGE_V3_DEC_LAYERS * steps:
            fail(f"rank {rep['rank']}: K2′ launched {n['permute_append_sharded']} times over {steps} steps")
        if n["permute_append"] or n["permute_rows"] or n["flash_attn_fwd"] != LARGE_V3_ENC_LAYERS * run["encodes"]:
            fail(f"rank {rep['rank']}: K2 {n['permute_append']}, K4 {n['permute_rows']} (expected 0), "
                 f"K1 {n['flash_attn_fwd']} (expected {LARGE_V3_ENC_LAYERS * run['encodes']})")
        forwards = 2 + steps  # detection, prefill, steps
        if n["cross_attend"] != LARGE_V3_DEC_LAYERS * forwards:
            fail(f"rank {rep['rank']}: cross_attend launched {n['cross_attend']} times, expected "
                 f"{LARGE_V3_DEC_LAYERS} × {forwards} decoder forwards")
        k2s.append(n["permute_append_sharded"])
        cross.append(n["cross_attend"])
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
    return k2s, cross


TP_BUDGET = 32  # phase 4e's tokens per row
TP_PER_FORWARD = 2 + 3 * LARGE_V3_DEC_LAYERS  # 98: embedding, o, cross o, fc2 × 32, logits
TP_PER_ENCODE = 2 * LARGE_V3_ENC_LAYERS  # 64: o and fc2 × 32


def _tp_expect(label: str, rep: dict, rec: dict, beam_run: bool, encodes: int, decodes: int) -> None:
    """Phase 4e's exact counts for one rank's record ``rec`` (a run, or one
    of its timed stages): K1 32 per encode, K4 2 per beam step, the
    cross-attention kernel 32 per decoder forward (its 10 local heads), no
    other kernel; collectives 64 per encode and 98 per decoder forward, by
    stage."""
    n, steps, col = rec["launches"], rec["steps"], rec["collectives"]
    want_k = {"flash_attn_fwd": LARGE_V3_ENC_LAYERS * encodes,
              "permute_rows": 2 * steps if beam_run else 0,
              "permute_append": 0, "permute_append_sharded": 0, "gather_attend": 0, "log_mel_fused": 0,
              "cross_attend": LARGE_V3_DEC_LAYERS * (2 * decodes + steps)}  # detection, prefill, steps
    if n != want_k:
        fail(f"4e {label}, rank {rep['rank']}: launches {n}, expected {want_k}")
    want_c = {}
    if encodes:
        want_c["encode"] = TP_PER_ENCODE * encodes
    if decodes:
        want_c.update(detect=TP_PER_FORWARD * decodes, prefill=TP_PER_FORWARD * decodes,
                      step=TP_PER_FORWARD * steps)
    if col["by_stage"] != want_c or col["calls"] != sum(want_c.values()):
        fail(f"4e {label}, rank {rep['rank']}: collectives {col}, expected {want_c}")


@contextlib.contextmanager
def _beam_trace(beam):
    """Record every selection round of ``beam_decode`` while the ``with``
    lasts: the per-beam top-(K+1) tokens (``topk_wide``) and the pool's
    scores, the kept candidates and their scores (``select_candidates``),
    on the host, one dict per round (the first expansion first)."""
    rounds = []
    topk, select = beam.topk_wide, beam.select_candidates

    def traced_topk(x, k):
        vals, idx = topk(x, k)
        rounds.append({"tok": idx.cpu()})
        return vals, idx

    def traced_select(scores, is_eot, k):
        sel = select(scores, is_eot, k)
        rounds[-1].update(scores=scores.float().cpu(), act=sel.act_idx.cpu(),
                          act_scores=sel.act_scores.float().cpu())
        return sel

    beam.topk_wide, beam.select_candidates = traced_topk, traced_select
    try:
        yield rounds
    finally:
        beam.topk_wide, beam.select_candidates = topk, select


@contextlib.contextmanager
def _row_parallel_f32(torch, params):
    """While the ``with`` lasts, this process forms its row-parallel
    products (o, cross o, fc2 of ``params``, its engine's tree) from f32
    operands and rounds them once, as a tensor-parallel rank does: the
    ranks' arithmetic but for the order of the f32 sums. Yields the list
    whose length counts those products."""
    from whisper_tpu_torch.models import layers

    rows = set()
    for part in ("encoder", "decoder"):
        for b in params[part]["blocks"]:
            rows.update(id(b[n]["o"]) for n in ("attn", "cross") if n in b)
            rows.add(id(b["mlp"]["fc2"]))
    plain, hits = layers.linear, []

    def linear(p, x, tp=None):
        if id(p) not in rows:
            return plain(p, x, tp)
        hits.append(1)
        y = torch.matmul(x.float(), (p["w_q"] if "w_q" in p else p["w"]).float())
        if "w_q" in p:
            y = y * p["w_s"].float()
        return (y + p["b"].float()).to(x.dtype) if "b" in p else y.to(x.dtype)

    layers.linear = linear
    try:
        yield hits
    finally:
        layers.linear = plain


def _beam_flip_gap(rounds, i: int, k: int, generated: list, what: str) -> tuple:
    """The single process's margin against another run's hypothesis
    ``generated`` (utterance ``i``'s tokens after the prompt), from its
    beam trace: walk the rounds while the hypothesis's prefix is among the
    kept beams; where it is dropped, the gap is the K-th kept candidate's
    score less the hypothesis's candidate's (sum-logprob nats, the units
    of a greedy top-2 gap); where it is kept to the end, the gap between
    the two final beams' scores. Fails (``what`` names the run) where the
    hypothesis's token is not in its source beam's top K + 1: that is no
    near tie. Returns (gap, round)."""
    beams = None  # the kept prefixes after each round
    for r, rd in enumerate(rounds):
        if r == 0:  # the first expansion: one pool of K + 1 per utterance
            toks = rd["tok"][i].tolist()
            srcs = [0] * len(toks)
            prev = [[]]
        else:
            toks = rd["tok"][i * k : (i + 1) * k].reshape(-1).tolist()
            srcs = [c // (k + 1) for c in range(len(toks))]
            prev = beams
        scores, act = rd["scores"][i].tolist(), rd["act"][i].tolist()
        kept = [prev[srcs[c]] + [toks[c]] for c in act]
        want = generated[: r + 1]
        if want not in kept:
            src = next((j for j, pre in enumerate(prev) if pre == generated[:r]), None)
            kth = rd["act_scores"][i][-1].item()
            pool = [c for c in range(len(toks)) if srcs[c] == src]
            hit = [c for c in pool if toks[c] == generated[r]]
            if not hit:
                fail(f"{what}: row {i}'s token {generated[r]} at round {r} is not among the single "
                     f"process's top {k + 1} of its beam: not a near tie")
            return kth - scores[hit[0]], r
        beams = kept
        if r + 1 == len(generated):
            break
    final = rounds[min(len(generated), len(rounds)) - 1]["act_scores"][i].tolist()
    mine = beams.index(generated[: len(beams[0])])
    return max(final) - final[mine], len(rounds) - 1


def _language_gap(torch, engine, host_row: np.ndarray, audio_ctx) -> float:
    """The top-2 gap of the language detection's logits for one utterance
    (alone, at the batch's crop ``audio_ctx``): how near a tie its
    language pick was."""
    from whisper_tpu_torch.decode.language import detect_language_tokens

    batch, _, _ = engine._prepare_batch(host_row[None])
    enc = engine._encode(batch[:1], audio_ctx)
    _, probs = detect_language_tokens(
        engine.assets.params, enc, engine.dims, sot=engine.vocab.specials.sot,
        compute_dtype=engine._compute_dtype, return_probs=True,
    )
    top = torch.topk(torch.log(probs[0].float()), 2).values  # log-softmax: logits less a constant
    return float(top[0] - top[1])


def phase_tensor_parallel(torch, main_engine, beam_engine) -> dict:
    """The tensor-parallel path (docstring, phase 4e). Returns K1's and
    K4's launches per rank and the run's numbers."""
    from whisper_tpu_torch.utils.checkpoint import save_params

    _, batch, audio_s = main_path_batch()
    out = {}
    with tempfile.TemporaryDirectory() as ckdir:
        npz = os.path.join(ckdir, "large-v3.npz")
        t0 = time.perf_counter()
        save_params(npz, main_engine.assets.params, main_engine.dims)
        log(f"  phase 4's weights written to an npz in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(npz) / 1e9:.3f} GB); each rank restores its slice from it")
        for label, engine in (("greedy", main_engine), ("flagship", beam_engine)):
            out[label] = _tp_leg(torch, label, engine, main_engine, npz, batch, audio_s)
    return out


# Each rank's peak memory when it drew the whole tree on the card and cut
# it (``--seed`` in place of ``--checkpoint``; H100 80GB HBM3, 700.00 W):
# greedy, flagship.
TP_PEAK_FROM_RANDOM_GB = {"greedy": 4.679, "flagship": 5.456}


def _tp_leg(torch, label, engine, main_engine, npz, batch, audio_s) -> dict:
    """One leg of phase 4e (greedy or the flagship): two ranks restore
    their slices of ``npz`` (phase 4's weights) and run; checks and
    numbers as the docstring says."""
    from whisper_tpu_torch.decode import beam as beam_search
    from whisper_tpu_torch.models.quantize import param_bytes
    from whisper_tpu_torch.parallel._dist_worker import launch, params_checksum
    from whisper_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(engine.config, max_new_tokens=TP_BUDGET)
    beam_run = cfg.beam_size > 1
    flags = ["--beam", str(cfg.beam_size), "--fused-step", "auto"]
    if cfg.quantization:
        flags += ["--quantization", cfg.quantization, "--kv-cache-dtype", cfg.kv_cache_dtype]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "batch.npy"), batch)
        reports = launch(2, [
            "--npy", os.path.join(tmp, "batch.npy"), "--model", cfg.model, "--checkpoint", npz,
            "--device", "cuda", "--dtype", cfg.dtype, "--mesh", "1,2",
            "--max-new", str(TP_BUDGET), "--stages", *flags,
        ], tmp, timeout=600)
    launch_s = time.perf_counter() - t0
    # The ranks quantise phase 4's tree on the host as they read it; the
    # flagship's tree was quantised on the card, which phase 4b holds equal.
    assets = engine.assets
    ref = assets.params
    whole = param_bytes(ref)
    tree_bytes = param_bytes(main_engine.assets.params)  # the whole tree the npz holds
    for rep in reports:
        run = rep["runs"]["auto"]
        share = rep["param_bytes"] / whole
        mesh = types.SimpleNamespace(model_index=rep["rank"], model_size=2)
        want = params_checksum(shard_params(ref, mesh, engine.dims))
        log(f"  {label}, rank {rep['rank']} of mesh {tuple(rep['mesh'])} on {rep['device']}: "
            f"{rep['param_bytes'] / 1e9:.3f} GB of weights ({share:.4f} of phase 4's "
            f"{whole / 1e9:.3f} GB), restored from the npz in {rep['restore_ms']:.1f} host ms; "
            f"max_memory_allocated {rep['max_memory_allocated'] / 1e9:.3f} GB (the whole tree "
            f"{tree_bytes / 1e9:.3f} GB; ranks that drew it whole on the card: "
            f"{TP_PEAK_FROM_RANDOM_GB[label]:.3f} GB); checksum {rep['params_checksum']} "
            f"(the cut of this process's tree: {want}); "
            f"run {run['seconds'] * 1e3:.1f} ms → {audio_s / run['seconds']:.2f} audio-s/s "
            f"(two ranks on one card: not a scaling number); launches {run['launches']}; "
            f"collectives {run['collectives']['by_stage']}")
        if not 0.48 <= share <= 0.52:
            fail(f"4e {label}, rank {rep['rank']}: holds {share:.4f} of the weights, expected about half")
        if rep["params_checksum"] != want:
            fail(f"4e {label}, rank {rep['rank']}: restored weights {rep['params_checksum']} are not "
                 f"shard_params of this process's tree at its index ({want})")
        if rep["max_memory_allocated"] >= tree_bytes:
            fail(f"4e {label}, rank {rep['rank']}: peak memory {rep['max_memory_allocated']} is not "
                 f"below the whole tree's {tree_bytes} bytes")
        _tp_expect(label, rep, run, beam_run, encodes=1, decodes=1)
        _tp_expect(f"{label} encode", rep, run["encode"], beam_run, encodes=1, decodes=0)
        _tp_expect(f"{label} decode", rep, run["decode"], beam_run, encodes=0, decodes=1)
        dec = run["decode"]
        steps = max(dec["steps"], 1)
        log(f"    encode {run['encode']['ms']:.1f} ms ({run['encode']['collectives']['host_ms']:.1f} host ms "
            f"in its 64 collectives); decode {dec['ms']:.1f} ms over {dec['steps']} steps = "
            f"{dec['ms'] / steps:.2f} ms/token, {dec['collectives']['host_ms']:.1f} host ms in its "
            f"{dec['collectives']['calls']} collectives ({dec['collectives']['host_ms'] / steps:.2f} per step)")
    results = reports[0]["runs"]["auto"]["results"]
    if reports[1]["runs"]["auto"]["results"] != results or len(results) != len(LENGTHS_S):
        fail(f"4e {label}: the ranks returned different result lists")
    # This process's engine on the same weights at the same budget (its
    # beam rounds traced, for the margin of a flip). The trace reads every
    # round on the host, so this engine decodes eagerly: a captured step
    # (decode/graph.py) would run the trace once, at capture.
    single = type(engine)(assets, cfg, device=engine.device)
    single._graphs = None
    with _beam_trace(beam_search) as rounds:
        ref = single.transcribe_batch(batch)
    flips = []
    p_len = len(single._prompt)
    for i, (g, r) in enumerate(zip(results, ref)):
        want = r.tokens[: r.length].tolist()
        if g["tokens"] == want:
            continue
        p = next((j for j, (a, b) in enumerate(zip(g["tokens"], want)) if a != b),
                 min(len(g["tokens"]), len(want)))
        if p == single._sot_index + 1:  # the detected language
            gap = _language_gap(torch, single, batch[i], reports[0]["audio_ctx"])
            how = "language detection's top-2 gap"
        elif beam_run:  # the beam's own margin: the K-th kept candidate against the row's
            gap, rnd = _beam_flip_gap(rounds, i, cfg.beam_size, g["tokens"][p_len:], f"4e {label}")
            how = f"beam margin at round {rnd}"
        else:
            gap, how = _top2_gap(torch, single, batch[i], r.tokens, p), "top-2 gap"
        log(f"    {label} row {i}: leaves the single process's tokens at position {p} "
            f"({want[p] if p < len(want) else None} → "
            f"{g['tokens'][p] if p < len(g['tokens']) else None}), its {how} {gap:.4f}")
        if gap >= BF16_NEAR_TIE:
            fail(f"4e {label}: row {i} differs at a pick {gap:.4f} from a tie (rule: < {BF16_NEAR_TIE})")
        flips.append({"row": i, "position": p, "gap": gap})
    with _row_parallel_f32(torch, single.assets.params) as hits:
        same = single.transcribe_batch(batch)
    alike = [i for i, (g, r) in enumerate(zip(results, same)) if g["tokens"] == r.tokens[: r.length].tolist()]
    log(f"  information: {label}: rows {alike} of {len(results)} equal this process run with the ranks' "
        f"arithmetic ({len(hits)} row-parallel products from f32 operands, rounded once)")
    log(f"  {label}: both ranks return the same {len(results)} results; "
        f"{len(results) - len(flips)} of {len(results)} rows equal this process's engine at "
        f"{TP_BUDGET} tokens, {len(flips)} near-tie flips; launch {launch_s:.1f} s")
    return {
        "k1_per_rank": [rep["runs"]["auto"]["launches"]["flash_attn_fwd"] for rep in reports],
        "k4_per_rank": [rep["runs"]["auto"]["launches"]["permute_rows"] for rep in reports],
        "cross_per_rank": [rep["runs"]["auto"]["launches"]["cross_attend"] for rep in reports],
        "steps": reports[0]["runs"]["auto"]["steps"],
        "decode_ms_per_token": reports[0]["runs"]["auto"]["decode"]["ms"]
        / max(reports[0]["runs"]["auto"]["decode"]["steps"], 1),
        "decode_collective_host_ms": reports[0]["runs"]["auto"]["decode"]["collectives"]["host_ms"],
        "encode_ms": reports[0]["runs"]["auto"]["encode"]["ms"],
        "encode_collective_host_ms": reports[0]["runs"]["auto"]["encode"]["collectives"]["host_ms"],
        "param_bytes_per_rank": [rep["param_bytes"] for rep in reports],
        "max_memory_allocated": [rep["max_memory_allocated"] for rep in reports],
        "flips": flips,
        "rows_equal_to_the_ranks_arithmetic": alike,
        "restore_ms": [rep["restore_ms"] for rep in reports],
    }


# Phase 4f's batches: seconds of each utterance. Content ends at 9, 4, 18
# and 30 s: "auto" crops 512, 256, 1024 and the full window; the batch of 3
# rows pads to the bucket of 4 with a row of silence.
STREAM_LENGTHS_S = ((3.0, 5.0, 7.0, 9.0), (1.5, 2.0, 3.0, 4.0), (10.0, 14.0, 18.0), (12.0, 20.0, 25.0, 30.0))


def stream_batches():
    """Phase 4f's 4 batches of synthetic utterances ([rows, 480000] f32)
    and their seconds of audio."""
    batches, seed = [], 0
    for lengths in STREAM_LENGTHS_S:
        batch = np.zeros((len(lengths), 480_000), np.float32)
        for i, sec in enumerate(lengths):
            u = synthetic_utterance(sec, seed)
            batch[i, : len(u)] = u
            seed += 1
        batches.append(batch)
    return batches, float(sum(map(sum, STREAM_LENGTHS_S)))


@contextlib.contextmanager
def _stream_witness(torch, engine, beam):
    """While the ``with`` lasts, ``engine``'s batch stream is watched: each
    encode's enqueue runs under ``torch.cuda.set_sync_debug_mode("error")``
    (a host sync in it raises), the encode stream must not be the decode
    stream, events are recorded around each encode's enqueue (on the
    encode stream; with its host ms) and at the start and end of each
    decode (on the current stream), with the decode's steps. Yields the record, which the loop of
    ``transcribe_batch`` fills too (its decodes only)."""
    rec = {"encode": [], "decode": [], "streams": set()}
    encode, decode = engine._stream_encode, engine._decode

    def stream_encode(stream, job):
        if stream.encode.cuda_stream == stream.decode.cuda_stream or \
                stream.decode.cuda_stream != torch.cuda.current_stream().cuda_stream:
            fail("4f: the encode stream is the decode stream, or the decode is not on the current stream")
        rec["streams"].add((stream.copy.cuda_stream, stream.encode.cuda_stream, stream.decode.cuda_stream))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream.encode)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            job = encode(stream, job)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record(stream.encode)
        rec["encode"].append((start, end, host_ms))
        return job

    from whisper_tpu_torch.decode import greedy

    def timed_decode(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        steps = beam.steps + greedy.steps
        start.record()
        out = decode(*a, **kw)
        end.record()
        rec["decode"].append((start, end, beam.steps + greedy.steps - steps))
        return out

    engine._stream_encode, engine._decode = stream_encode, timed_decode
    try:
        yield rec
    finally:
        del engine._stream_encode, engine._decode


def phase_batch_stream(torch, kernels, beam, main_engine, beam_engine) -> dict:
    """The batch stream at full width (docstring, phase 4f). Returns, per
    config, the stream's launches and its numbers."""
    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    batches, audio_s = stream_batches()
    # The debug mode must see a host sync: a witness that the check can fail.
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
        fail("4f: set_sync_debug_mode('error') let a host sync (.item()) through")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    crops = [main_engine._resolve_audio_ctx(main_engine._prepare_batch(b)[0]) for b in batches]
    log(f"  {len(batches)} batches of {[b.shape[0] for b in batches]} rows, {audio_s:.1f} s of audio, "
        f"\"auto\" crops {crops}")
    out = {}
    for label, engine in (("greedy", main_engine), ("flagship", beam_engine)):
        runs = [_stream_run(torch, kernels, beam, engine, batches, way) for way in STREAM_ORDER]
        for r in runs:
            log(f"  {label} {r['way']}: {r['wall'] * 1e3:.1f} ms → {audio_s / r['wall']:.2f} audio-s/s; decode "
                f"{r['decode_ms']:.1f} device-clock ms over {r['steps']} steps = {r['decode_ms_per_token']:.2f} "
                f"ms/token; max_memory_allocated {r['peak'] / 1e9:.3f} GB; launches {r['launches']}; "
                f"cross_attend {r['cross']['cross']} ({r['cross']['decoder_forwards']} bf16 decoder forwards)")
        first = runs[0]
        want = {"K1": LARGE_V3_ENC_LAYERS * len(batches),
                "K2": LARGE_V3_DEC_LAYERS * first["beam_steps"] if engine.config.beam_size > 1 else 0,
                "K2′": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}
        for r in runs:
            if r["launches"] != want or (engine.config.beam_size > 1 and r["beam_steps"] == 0):
                fail(f"4f {label} {r['way']}: launched {r['launches']}, expected {want}")
            check_cross(f"4f {label} {r['way']}", r["cross"])
            for i, (a_list, b_list) in enumerate(zip(r["results"], first["results"])):
                if len(a_list) != len(b_list) or len(a_list) != batches[i].shape[0]:
                    fail(f"4f {label} {r['way']}: batch {i} gave {len(a_list)} results, the loop {len(b_list)}")
                check_results(a_list, engine, engine.dims.n_vocab)
                for j, (a, b) in enumerate(zip(a_list, b_list)):
                    if not np.array_equal(a.tokens, b.tokens) or a.length != b.length or a.text != b.text:
                        fail(f"4f {label} {r['way']}: batch {i} row {j}: tokens {a.tokens[:a.length].tolist()} "
                             f"differ from the loop's {b.tokens[:b.length].tolist()}")
        overlap = []
        for r in runs:
            if r["way"] != "stream":
                continue
            rec = r["rec"]
            if len(rec["encode"]) != len(batches) or len(rec["streams"]) != 1:
                fail(f"4f {label}: {len(rec['encode'])} encodes on {len(rec['streams'])} stream sets")
            for i in range(len(batches) - 1):
                start, end, _ = rec["decode"][i]
                enc_start, enc, host_ms = rec["encode"][i + 1]
                after_start, before_end = start.elapsed_time(enc), enc.elapsed_time(end)
                inside = after_start > 0 and before_end >= 0
                overlap.append({"batch": i, "inside": inside, "ms_after_decode_start": after_start,
                                "ms_before_decode_end": before_end, "encode_host_ms": host_ms,
                                "encode_device_window_ms": enc_start.elapsed_time(enc)})
                log(f"    overlap: encode({i + 1}) (enqueued in {host_ms:.1f} host ms, "
                    f"{enc_start.elapsed_time(enc):.1f} ms on the encode stream) ended {after_start:.2f} ms "
                    f"after decode({i}) started and {before_end:.2f} ms before it ended: "
                    f"{'inside' if inside else 'outside'} its window")
        rate = {way: [audio_s / r["wall"] for r in runs if r["way"] == way] for way in ("loop", "stream")}
        log(f"  {label}: tokens and text of every row of every run equal the first loop's; the stream "
            f"{statistics.mean(rate['stream']) / statistics.mean(rate['loop']):.3f}× the loop's mean "
            f"audio-s/s (runs in the order {' '.join(STREAM_ORDER)}); no host sync in "
            f"{STREAM_ORDER.count('stream') * len(batches)} encode enqueues")
        out[label] = {
            "launches": dict(first["launches"], cross=first["cross"]["cross"]),
            "audio_s_per_s": rate,
            "decode_ms_per_token": {way: [r["decode_ms_per_token"] for r in runs if r["way"] == way]
                                    for way in ("loop", "stream")},
            "max_memory_allocated": {way: max(r["peak"] for r in runs if r["way"] == way)
                                     for way in ("loop", "stream")},
            "overlap": overlap,
        }
    return out


STREAM_ORDER = ("loop", "stream", "stream", "loop")  # in turns: the host's load drifts


def _stream_run(torch, kernels, beam, engine, batches, way) -> dict:
    """One run of phase 4f's batches, ``transcribe_batches`` ("stream") or a
    loop of ``transcribe_batch`` ("loop"), watched by
    :func:`_stream_witness`, with its launches and peak memory."""
    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    with _stream_witness(torch, engine, beam) as rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)  # counts start here: this run
        beam.steps = 0
        t0 = time.perf_counter()
        if way == "stream":
            results = engine.transcribe_batches(batches)
        else:
            results = [engine.transcribe_batch(b) for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": attention.launches, "K2": fused_step.launches,
                    "K2′": fused_step.sharded_launches, "K3": gather_attend.launches,
                    "K4": gather.launches, "K5": mel_fused.launches, "K6": fp8_upcast.launches}
        beam_steps, cross = beam.steps, CROSS.counts()  # counts end here
    decode_ms = sum(s.elapsed_time(e) for s, e, _ in rec["decode"])
    steps = sum(n for _, _, n in rec["decode"])
    return dict(way=way, results=results, wall=wall, launches=launches, beam_steps=beam_steps, rec=rec, cross=cross,
                decode_ms=decode_ms, steps=steps, decode_ms_per_token=decode_ms / max(steps, 1),
                peak=torch.cuda.max_memory_allocated())


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
    from whisper_tpu_torch.decode import beam as beam_search
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
    with _beam_trace(beam_search) as cpu_q_rounds:  # the int8+fp8 checks read its margins
        cpu_q = beam_run("cpu", "off", **q8)
    (first, ref), *rest = runs.items()
    for r in ref:
        log(f"  beam 3, {first}: {r.tokens[: r.length].tolist()}")
    for name, res in rest:
        for a, b in zip(ref, res):
            if not np.array_equal(a.tokens, b.tokens) or a.language != b.language:
                fail(f"tiny f32 beam 3: {name} tokens {b.tokens[: b.length].tolist()} differ from {first}'s")
        log(f"  beam 3, {name}: equal")
    # int8 + fp8 KV: the near-tie rule of the tensor-parallel legs below. An
    # fp8 store rounds to 3 mantissa bits, so a last-bit f32 difference
    # (the card's summation order) moves a stored K or V value by a whole
    # step where it lies at a rounding edge: a row may leave the CPU's
    # tokens only where the CPU's own beam margin there is below 0.25.
    card_q, flips = beam_run("cuda", "hybrid", **q8), 0
    for i, (a, b) in enumerate(zip(card_q, cpu_q)):
        log(f"  beam 3, cpu off int8+fp8: {b.tokens[: b.length].tolist()}")
        if np.array_equal(a.tokens, b.tokens) and a.language == b.language:
            continue
        what = f"tiny f32 beam 3 int8+fp8, card hybrid against cpu off, row {i}"
        if a.language != b.language:
            fail(f"{what}: language {a.language} differs from the CPU's {b.language}")
        p_len = len(b.tokens) - cfg.max_new_tokens
        gap, rnd = _beam_flip_gap(cpu_q_rounds, i, 3, a.tokens[p_len : a.length].tolist(), what)
        log(f"  beam 3, card hybrid int8+fp8, row {i}: {a.tokens[: a.length].tolist()}, leaves the CPU's "
            f"tokens at round {rnd}, the CPU's margin there {gap:.4f} (rule: < {BF16_NEAR_TIE})")
        if gap >= BF16_NEAR_TIE:
            fail(f"{what}: tokens differ at a margin of {gap:.4f}, not a near tie")
        flips += 1
    log(f"  beam 3, card hybrid int8+fp8: equal to cpu off but for {flips} near-tie flips")

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
            if (steps == 0 or (n["permute_append_sharded"], n["permute_rows"]) != want or n["permute_append"]
                    or n["cross_attend"]):
                fail(f"tiny DP(2) {mode}, rank {rep['rank']}: K2′ {n['permute_append_sharded']}, "
                     f"K4 {n['permute_rows']}, K2 {n['permute_append']}, cross_attend {n['cross_attend']} "
                     f"(f32: 0) over {steps} steps")
        log(f"  beam 3, DP(2) on the card, {mode}: both ranks equal to cpu off "
            f"(K2′ {reports[0]['runs'][mode]['launches']['permute_append_sharded']} launches on rank 0)")
    phase_tp_card_vs_cpu(torch, params, cfg, x, {"greedy": cpu, "beam 3 off": runs["cpu off"],
                                                 "beam 3 int8+fp8": cpu_q}, cpu_q_rounds)

    phase_options_card_vs_cpu(params, cfg, x, Monolith)
    phase_serving_card_vs_cpu(torch, params, cfg, Monolith)
    phase_speculative_card_vs_cpu(params, cfg, x, Monolith, card)


def phase_tp_card_vs_cpu(torch, params, cfg, x, cpu_runs, fp8_rounds) -> None:
    """Phase 5's tensor parallelism: ``tiny`` f32 (TF32 off) on the meshes
    (1, 2) and (2, 2), every rank on this card, greedy, beam 3 "off" and
    beam 3 int8 + fp8 KV: every rank's tokens equal the CPU's single
    process (``cpu_runs``). Under the fp8 cache one exception: a row may
    leave the CPU's tokens where the CPU's own beam margin there
    (``fp8_rounds``, its traced rounds; :func:`_beam_flip_gap`) is below
    0.25. An fp8 store rounds to 3 mantissa bits, so a last-bit f32
    difference (another summation order: the model group's partial sums,
    a rank's batch of 1) moves a stored K or V value by a whole step where
    it lies at a rounding edge; every flip is printed with its margin."""
    from whisper_tpu_torch.parallel._dist_worker import launch

    configs = {
        "greedy": [],
        "beam 3 off": ["--beam", "3", "--fused-step", "off"],
        "beam 3 int8+fp8": ["--beam", "3", "--quantization", "int8", "--kv-cache-dtype", FP8],
    }
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(params, os.path.join(tmp, "params.pt"))
        np.save(os.path.join(tmp, "x.npy"), x)
        for mesh in ((1, 2), (2, 2)):
            n = mesh[0] * mesh[1]
            for name, flags in configs.items():
                t0 = time.perf_counter()
                reports = launch(n, [
                    "--npy", os.path.join(tmp, "x.npy"), "--params", os.path.join(tmp, "params.pt"),
                    "--model", cfg.model, "--device", "cuda", "--dtype", cfg.dtype,
                    "--max-new", str(cfg.max_new_tokens), "--mesh", f"{mesh[0]},{mesh[1]}", *flags,
                ], tmp, timeout=300)
                flips = []
                for rep in reports:
                    run = rep["runs"]["auto" if name != "beam 3 off" else "off"]
                    for i, (g, b) in enumerate(zip(run["results"], cpu_runs[name])):
                        if g["tokens"] == b.tokens[: b.length].tolist():
                            continue
                        if name == "beam 3 int8+fp8":
                            p_len = len(b.tokens) - cfg.max_new_tokens
                            gap, rnd = _beam_flip_gap(fp8_rounds, i, 3, g["tokens"][p_len:],
                                                      f"tiny f32 {name}, mesh {mesh}, rank {rep['rank']}")
                            if gap < BF16_NEAR_TIE:
                                flips.append(f"row {i} at round {rnd}, the CPU's margin {gap:.4f}")
                                continue
                        fail(f"tiny f32 {name}, mesh {mesh} on the card, rank {rep['rank']}: tokens "
                             f"{g['tokens']} differ from the CPU's {b.tokens[: b.length].tolist()}")
                    if run["launches"]["permute_append"] or run["launches"]["permute_append_sharded"]:
                        fail(f"tiny f32 {name}, mesh {mesh}: K2 or K2′ ran on a model axis of 2")
                    if run["launches"]["cross_attend"]:
                        fail(f"tiny f32 {name}, mesh {mesh}: the cross-attention kernel ran in f32")
                run0 = reports[0]["runs"]["auto" if name != "beam 3 off" else "off"]
                same = "every rank equal to the CPU's single process" + (
                    f" but for near-tie flips under fp8 storage: {sorted(set(flips))}" if flips else "")
                log(f"  {name}, mesh {mesh} ({n} ranks on the card): {same} (K1 {run0['launches']['flash_attn_fwd']}, K4 "
                    f"{run0['launches']['permute_rows']}, {run0['collectives']['calls']} collectives on "
                    f"rank 0; {time.perf_counter() - t0:.1f} s)")


def phase_speculative_card_vs_cpu(params, cfg, x, Monolith, card_greedy) -> None:
    """Phase 5's part for speculative decoding (docstring), tiny f32: with
    ``max_new_tokens=None`` (the decode reaches the end of the 448-token
    context) a random ``tiny`` draft and a self-draft on the card give
    greedy's tokens, and the self-draft on the CPU the same; a ``dev``
    draft (another encoder width: its own mel and encoder) under the tiny
    target gives greedy's tokens on the card and the CPU's."""
    from whisper_tpu_torch.models.params import to_device

    full = dataclasses.replace(cfg, max_new_tokens=None)
    spec = dataclasses.replace(full, draft_model="tiny", k_draft=4)
    greedy = Monolith.from_assets(params, full, device="cuda").transcribe_batch(x)
    runs = {}
    for name, device, draft in (("random tiny draft, card", "cuda", None),
                                ("self-draft, card", "cuda", params), ("self-draft, CPU", "cpu", params)):
        eng = Monolith.from_assets(params, spec, device=device, draft_params=draft)
        runs[name] = (eng.transcribe_batch(x), eng.last_spec_stats)
    log(f"  speculative, max_new_tokens=None: greedy lengths {[r.length for r in greedy]} "
        f"of {len(greedy[0].tokens)}")
    for name, (res, stats) in runs.items():
        log(f"  speculative, {name}: {stats}")
        if not all(_same_tokens(a, b) for a, b in zip(res, greedy)):
            fail(f"tiny f32 speculative ({name}, to the end of the context) differs from greedy on the card")
    log("  speculative to the end of the context: card random draft == card self-draft == CPU self-draft "
        "== card greedy")

    own = dataclasses.replace(cfg, draft_model="dev", k_draft=3)
    card_eng = Monolith.from_assets(params, own, device="cuda")
    cpu_eng = Monolith.from_assets(params, own, device="cpu", draft_params=to_device(card_eng._draft_params, "cpu"))
    if card_eng._draft_share_encoder:
        fail("a dev draft under a tiny target should run its own encoder")
    card_res, cpu_res = card_eng.transcribe_batch(x), cpu_eng.transcribe_batch(x)
    if not all(_same_tokens(a, b) and _same_tokens(a, c) for a, b, c in zip(card_res, cpu_res, card_greedy)):
        fail("tiny f32 with a dev draft (own encoder): card, CPU and greedy tokens differ")
    log(f"  speculative, dev draft with its own encoder: card == CPU == greedy ({card_eng.last_spec_stats})")


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
    """Phase 6a for one slot-pool class: the utterances in waves of 4,
    launches counted over the run."""
    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    pool = cls(engine, n_slots=8, prefill_batch=2)
    pool.warmup()
    reset_counts(*kernels)  # counts start here: the slot pool's run
    with pool:
        results, lat, wall = _drive(pool, utts, [list(range(i, i + 4)) for i in range(0, len(utts), 4)])
    torch.cuda.synchronize()
    k1, cross = attention.launches, CROSS.counts()
    others = (fused_step.launches, fused_step.sharded_launches, gather_attend.launches, gather.launches,
              mel_fused.launches, fp8_upcast.launches)  # counts end here
    check_results(results, engine, engine.dims.n_vocab)
    audio_s = sum(len(u) for u in utts) / 16_000.0
    p50, p95, line = _latency_line(lat, audio_s, wall)
    prefills, steps = pool._prefill_dispatches, pool._step_dispatches
    log(f"  {cls.__name__}: {len(utts)} utterances ({audio_s:.1f} s of audio) in {wall * 1e3:.1f} ms; {line}; "
        f"occupancy {pool.occupancy:.3f}, dispatch efficiency {pool.dispatch_efficiency:.3f}, "
        f"{steps} macro-steps of {pool.sync_every} steps, {prefills} prefill dispatches")
    log(f"    launches: K1 {k1} ({prefills} prefills × {LARGE_V3_ENC_LAYERS} layers); K2, K2′, K3, K4, K5, K6 "
        f"{others}; cross_attend {cross['cross']} ({cross['decoder_forwards']} bf16 decoder forwards)")
    if k1 != LARGE_V3_ENC_LAYERS * prefills or prefills == 0:
        fail(f"{cls.__name__}: K1 launched {k1} times, expected {LARGE_V3_ENC_LAYERS} × {prefills} prefills")
    if any(others):
        fail(f"{cls.__name__}: K2, K2′, K3, K4, K5, K6 launched {others} times, expected none")
    check_cross(f"6a {cls.__name__}", cross)
    return {"class": cls.__name__, "results": results, "k1": k1, "cross": cross["cross"],
            "prefill_dispatches": prefills,
            "macro_steps": steps, "latency_p50_s": p50, "latency_p95_s": p95, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "occupancy": pool.occupancy,
            "dispatch_efficiency": pool.dispatch_efficiency}


def phase_serving(torch, kernels, EngineConfig, EngineType, create_engine) -> tuple:
    """Phase 6a (docstring). Returns the engine and each class's record."""
    from whisper_tpu_torch.engine.serving import ContinuousTranscriber, DisaggregatedTranscriber

    cfg = EngineConfig(model="large-v3", max_new_tokens=64, audio_ctx=None)
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")  # phase 4's weights
    utts = serving_utterances()[:8]  # two waves: the run's time budget
    records = [phase_slot_pool(torch, kernels, engine, utts, cls)
               for cls in (ContinuousTranscriber, DisaggregatedTranscriber)]
    single = [engine.transcribe(u) for u in utts[:4]]  # the first wave: the run's time budget
    for rec in records:
        agree = sum(_same_tokens(a, b) for a, b in zip(rec.pop("results"), single))
        log(f"  information: {rec['class']}: {agree} of the first wave's {len(single)} utterances "
            f"token-equal to engine.transcribe (bf16 at other batch shapes may flip near ties)")
        rec["agree_with_transcribe"] = agree
    return engine, records


def phase_async_flagship(torch, kernels, beam, engine) -> dict:
    """Phase 6b (docstring): 8 utterances from 4 threads through
    ``AsyncTranscriber(max_batch=4)`` over the flagship engine."""
    import threading

    from whisper_tpu_torch.engine.serving import AsyncTranscriber

    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
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
    k1, k2, steps, cross = attention.launches, fused_step.launches, beam.steps, CROSS.counts()
    others = (gather.launches, gather_attend.launches, mel_fused.launches, fused_step.sharded_launches,
              fp8_upcast.launches)  # counts end here
    flushes = batches_run() - flushes0
    if any(th.is_alive() for th in threads) or any(r is None for r in results):
        fail("async flagship: a client thread did not finish")
    check_results(results, engine, engine.dims.n_vocab)
    audio_s = sum(len(u) for u in utts) / 16_000.0
    p50, p95, line = _latency_line(lat, audio_s, wall)
    log(f"  AsyncTranscriber(max_batch=4), flagship: {len(utts)} utterances from 4 threads "
        f"({audio_s:.1f} s of audio) in {wall * 1e3:.1f} ms; {line}; {flushes} flushes, {steps} beam steps")
    log(f"    launches: K1 {k1} ({flushes} flushes × {LARGE_V3_ENC_LAYERS}), K2 {k2} ({steps} steps × "
        f"{LARGE_V3_DEC_LAYERS}); K4, K3, K5, K2′, K6 {others}; cross_attend {cross['cross']} "
        f"({cross['decoder_forwards']} bf16 decoder forwards)")
    if flushes == 0 or k1 != LARGE_V3_ENC_LAYERS * flushes:
        fail(f"async flagship: K1 launched {k1} times over {flushes} flushes")
    if steps == 0 or k2 != LARGE_V3_DEC_LAYERS * steps:
        fail(f"async flagship: K2 launched {k2} times over {steps} beam steps")
    if any(others):
        fail(f"async flagship: K4, K3, K5, K2′, K6 launched {others} times, expected none")
    check_cross("6b async flagship", cross)
    return {"k1": k1, "k2": k2, "cross": cross["cross"], "flushes": flushes, "beam_steps": steps, "latency_p50_s": p50,
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
    attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast = kernels
    return {"K1": attention.launches, "K2": fused_step.launches, "K2′": fused_step.sharded_launches,
            "K3": gather_attend.launches, "K4": gather.launches, "K5": mel_fused.launches,
            "K6": fp8_upcast.launches, "beam_steps": beam.steps, **CROSS.counts()}


def _expect(label: str, got: dict, want: dict, bf16: bool = True) -> None:
    """Every kernel's launches as ``want`` says (0 where it says nothing);
    the cross-attention kernel's as :func:`check_cross` says (``want``'s
    "cross" where given)."""
    bad = {k: (got[k], want.get(k, 0)) for k in ("K1", "K2", "K2′", "K3", "K4", "K5", "K6")
           if got[k] != want.get(k, 0)}
    if bad:
        fail(f"{label}: launches (got, expected) {bad}")
    check_cross(label, got, bf16, want.get("cross"))


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


LADDER_BUDGET = 32  # phases 7a and 7b: tokens per run of the ladder


def phase_ladder(torch, kernels, beam, engine, label) -> dict:
    """Phases 7a and 7b (docstring): ``engine``'s config with the default
    ladder and gates on phase 4's batch. K1 once per layer of every
    encode (the primary and each retry sub-batch), K2 once per layer of
    every beam step (a beam primary's only: the retries sample)."""
    from whisper_tpu_torch.decode.fallback import DEFAULT_TEMPERATURES

    _, batch, audio_s = main_path_batch()
    eng = _engine_with(engine, fallback_temperatures=DEFAULT_TEMPERATURES[1:],
                       max_new_tokens=LADDER_BUDGET)
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


def _top2_gap(torch, engine, host_row: np.ndarray, tokens: np.ndarray, p: int) -> float:
    """The target's top-2 gap of its rule-constrained logits for position
    ``p`` of greedy's row ``tokens`` (one utterance, teacher-forced over
    ``tokens[:p]`` in the engine's dtype): how near a tie the pick was."""
    from whisper_tpu_torch.models.decoder import decoder_prefill, init_kv_cache, precompute_cross_kv

    batch, _, _ = engine._prepare_batch(host_row[None])
    enc = engine._encode(batch[:1], engine._resolve_audio_ctx(batch[:1]))
    cross = precompute_cross_kv(engine.assets.params, enc, engine.dims)
    toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(engine.device)[None]
    cache = init_kv_cache(engine.dims, 1, p, dtype=engine._compute_dtype, device=engine.device)
    logits, _ = decoder_prefill(engine.assets.params, toks[:, :p], cache, cross, engine.dims,
                                engine._compute_dtype)
    x = logits[:, -1].float()
    if engine._logit_bias is not None:
        x = x + engine._logit_bias
    if engine._rules is not None:
        x = engine._rules.apply(x, toks, p, len(engine._prompt))
    top = torch.topk(x[0], 2).values
    return float(top[0] - top[1])


def _round_costs(torch, eng) -> dict:
    """One speculative round's parts at phase 8a's batch of 4, caches 36
    positions deep: a draft step (per-row positions), the target's window
    of k + 1 tokens, and the target's greedy step beside them. Each as the
    device time and kernel count of one call (``torch.profiler``: a call
    launches thousands of kernels, more than the launch queue holds behind
    :func:`time_ms`'s spin) and as synchronised host wall per call (the
    decode is host-bound: the wall is what a round pays)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.models.decoder import (
        decoder_step,
        decoder_window,
        init_kv_cache,
        precompute_cross_kv,
    )

    b, k, pos0, cdt = 4, eng.config.k_draft, 36, eng._compute_dtype
    gen = torch.Generator(device="cuda").manual_seed(8)
    sides = {}
    for side, params, dims in (("target", eng.assets.params, eng.dims),
                               ("draft", eng._draft_params, eng._draft_dims)):
        enc = torch.randn((b, dims.n_audio_ctx, dims.n_audio_state), generator=gen, device="cuda").to(cdt)
        cache = init_kv_cache(dims, b, 68 + k, dtype=cdt, device="cuda")
        sides[side] = (params, dims, precompute_cross_kv(params, enc, dims), cache)
    tok = torch.full((b,), 1000, dtype=torch.long, device="cuda")
    pos = torch.full((b,), pos0, dtype=torch.long, device="cuda")
    window = torch.full((b, k + 1), 1000, dtype=torch.long, device="cuda")
    pt, dt, xt, ct = sides["target"]
    pd, dd, xd, cd = sides["draft"]
    fns = {
        "draft_step": lambda: decoder_step(pd, tok, pos, cd, xd, dd, cdt),
        "target_window": lambda: decoder_window(pt, window, pos, ct, xt, dt, cdt),
        "target_step": lambda: decoder_step(pt, tok, pos0, ct, xt, dt, cdt),
    }
    out = {}
    for name, fn in fns.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": sum(e.device_time for e in kernels) / 3e3,  # device_time is µs
                     "kernels": len(kernels) // 3, "wall_ms": (time.perf_counter() - t0) * 1e2}
    return out


BF16_NEAR_TIE = 0.25  # 8b's rule: a row may leave phase 4's tokens only at a pick this near a tie


def phase_speculative(torch, kernels, beam, main_engine, phase4_results) -> dict:
    """Phase 8 (docstring): 8a large-v3 f32 with three drafts against
    greedy, tokens exact; 8b the default bf16 config with a distil-large-v3
    draft against phase 4. Each run's launch counts set to 0 just before
    and checked just after."""
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    _, batch, audio_s = main_path_batch()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {}
    base = create_engine(EngineType.MONOLITH, EngineConfig(model="large-v3", dtype="float32",
                                                           max_new_tokens=SPEC_F32_BUDGET), seed=0, device="cuda")
    greedy, wall, n = _timed(torch, kernels, beam, lambda: base.transcribe_batch(batch))
    check_results(greedy, base, base.dims.n_vocab)
    _expect("8a greedy", n, {"K1": LARGE_V3_ENC_LAYERS}, bf16=False)
    total = len(base._prompt) + base._max_new
    log(f"  8a greedy f32: {wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; lengths "
        f"{[r.length for r in greedy]} of {total}; launches {n}")
    record["8a_greedy"] = {"wall_s": wall, "audio_s_per_s": audio_s / wall, "launches": n,
                           "mel_encoder_ms": f32_encoder_ms(torch, kernels[0], base)}
    drafts = (
        ("self-draft", "large-v3", base.assets.params, LARGE_V3_ENC_LAYERS),
        ("distil-large-v3", "distil-large-v3", None, LARGE_V3_ENC_LAYERS),
        ("tiny", "tiny", None, LARGE_V3_ENC_LAYERS + 4),  # + its own encoder's 4 layers
    )
    for name, model, params, k1 in drafts:
        eng = type(base)(base.assets, dataclasses.replace(base.config, draft_model=model, k_draft=4),
                         device="cuda", draft_params=params)
        res, wall, n = _timed(torch, kernels, beam, lambda: eng.transcribe_batch(batch))
        st = eng.last_spec_stats
        log(f"  8a {name} (k 4, encoder {'shared' if eng._draft_share_encoder else 'its own'}): "
            f"{wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s; rounds {st['rounds']}, accepted "
            f"{st['accepted']} of {st['drafted']} ({st['accepted'] / st['drafted']:.3f}); launches {n}")
        _expect(f"8a {name}", n, {"K1": k1}, bf16=False)
        for a, b in zip(res, greedy):
            if not _same_tokens(a, b):
                fail(f"8a {name}: tokens {a.tokens[: a.length].tolist()} differ from greedy's "
                     f"{b.tokens[: b.length].tolist()}")
        costs = _round_costs(torch, eng)
        log("    one round's parts (device ms, kernels, host wall ms per call): " + "; ".join(
            f"{part} {c['device_ms']:.2f}, {c['kernels']}, {c['wall_ms']:.2f}" for part, c in costs.items()))
        if name == "self-draft" and max(r.length for r in greedy) == total:
            want = -(-(base._max_new - 1) // 5)  # after the first pick, k + 1 = 5 per round
            if st["rounds"] != want:
                fail(f"8a self-draft: {st['rounds']} rounds, expected {want}")
        record[f"8a_{name}"] = {"wall_s": wall, "audio_s_per_s": audio_s / wall, "launches": n, **st,
                                "round_costs": costs}
        del eng
    log("  8a: every draft's tokens equal greedy's")
    del base

    # 8b: the default bf16 config (phase 4's weights) with a distil draft.
    plain, wall_p, n_p = _timed(torch, kernels, beam, lambda: main_engine.transcribe_batch(batch))
    eng = _engine_with(main_engine, draft_model="distil-large-v3", k_draft=4)
    res, wall, n = _timed(torch, kernels, beam, lambda: eng.transcribe_batch(batch))
    check_results(res, eng, eng.dims.n_vocab)
    _expect("8b", n, {"K1": LARGE_V3_ENC_LAYERS})
    st = eng.last_spec_stats
    same = [_same_tokens(a, b) for a, b in zip(res, phase4_results)]
    log(f"  8b bf16, distil-large-v3 draft: {wall * 1e3:.1f} ms → {audio_s / wall:.2f} audio-s/s "
        f"(greedy in the same phase {wall_p * 1e3:.1f} ms → {audio_s / wall_p:.2f}); rounds {st['rounds']}, "
        f"accepted {st['accepted']} of {st['drafted']}; rows equal to phase 4's {sum(same)} of {len(same)}; "
        f"launches {n}")
    gaps = []
    for i, (a, b, ok) in enumerate(zip(res, phase4_results, same)):
        if ok:
            continue
        p = int(np.nonzero(a.tokens != b.tokens)[0][0])
        gap = _top2_gap(torch, main_engine, batch[i], b.tokens, p)
        gaps.append(gap)
        log(f"    row {i} first differs at position {p} ({b.tokens[p]} → {a.tokens[p]}): the target's "
            f"top-2 gap there {gap:.4f}")
        if gap >= BF16_NEAR_TIE:
            fail(f"8b: row {i} leaves phase 4's tokens at a pick {gap:.4f} from a tie (rule: < {BF16_NEAR_TIE})")
    record["8b_greedy"] = {"wall_s": wall_p, "audio_s_per_s": audio_s / wall_p, "launches": n_p}
    record["8b"] = {"wall_s": wall, "audio_s_per_s": audio_s / wall, "launches": n,
                    "rows_equal_phase4": sum(same), "top2_gaps": gaps, **st}
    return record


SPEC_F32_BUDGET = 32  # phase 8a's tokens per row


CLI_RUNNER = (
    "import atexit, json, runpy, sys\n"
    "import chip_smoke\n"
    "from whisper_tpu_torch.frontend import mel_fused\n"
    "from whisper_tpu_torch.ops import attention, fp8_upcast, fused_step, gather, gather_attend\n"
    "cross = chip_smoke.CROSS.install()\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps({'K1': attention.launches, "
    "'K2': fused_step.launches, 'K2′': fused_step.sharded_launches, 'K3': gather_attend.launches, "
    "'K4': gather.launches, 'K5': mel_fused.launches, 'K6': fp8_upcast.launches, **cross.counts()}), "
    "file=sys.stderr))\n"
    "sys.argv = ['whisper_tpu_torch.cli'] + sys.argv[1:]\n"
    "runpy.run_module('whisper_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
)


def _cli(args, timeout=600) -> tuple:
    """``python -m whisper_tpu_torch.cli ARGS`` in a subprocess (run as the
    ``-m`` module, its launch counts and the cross-attention witness,
    :data:`CROSS`, printed to stderr at exit) → (stdout, stderr, wall s,
    launches)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_RUNNER, *args], capture_output=True, text=True,
                         timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"whisper_tpu_torch.cli {' '.join(args)} exited {out.returncode}: {out.stderr[-3000:]}")
    line = [ln for ln in out.stderr.splitlines() if ln.startswith("LAUNCHES ")][-1]
    return out.stdout, out.stderr, wall, json.loads(line[len("LAUNCHES "):])


def phase_cli(torch) -> dict:
    """Phase 9 (docstring): ``python -m whisper_tpu_torch.cli`` on the card."""
    from whisper_tpu_torch.audio.wav import write_wav
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import Monolith
    from whisper_tpu_torch.models.convert import load_checkpoint, openai_state_dict
    from whisper_tpu_torch.models.params import init_params, leaves

    utts, _, _ = main_path_batch()
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        wavs = [os.path.join(tmp, f"utt{i}.wav") for i in (0, 1)]
        for path, u in zip(wavs, (utts[0], utts[2])):
            write_wav(path, u)
        big = ["--model", "large-v3", "--max-new-tokens", "64"]
        runs = {
            "greedy": ["transcribe", *wavs, *big, "--output-format", "all", "--output-dir", tmp, "--verbose"],
            "draft": ["transcribe", *wavs, *big, "--draft-model", "distil-large-v3"],
            "flagship": ["transcribe", *wavs, *big, "--beam-size", "5", "--quantize", "int8", "--kv-dtype", FP8],
        }
        for name, args in runs.items():
            stdout, _, wall, n = _cli(args)
            lines = [ln for ln in stdout.splitlines() if ln.strip()]
            log(f"  9 transcribe {name}: {wall:.1f} s (a process: start, random weights, build, 2 files); "
                f"{len(lines)} lines of text; launches {n}")
            if len(lines) < len(wavs):
                fail(f"9 {name}: {len(lines)} lines for {len(wavs)} files")
            if name == "flagship":
                if n["K2"] <= 0 or n["K2"] % LARGE_V3_DEC_LAYERS:
                    fail(f"9 flagship: K2 launched {n['K2']} times, expected 32 per beam step, > 0")
                _expect("9 flagship", n, {"K1": LARGE_V3_ENC_LAYERS, "K2": n["K2"]})
            else:
                _expect(f"9 {name}", n, {"K1": LARGE_V3_ENC_LAYERS})
            record[name] = {"wall_s": wall, "launches": n}
        for fmt in ("txt", "srt", "vtt", "tsv", "json"):
            for i in (0, 1):
                path = os.path.join(tmp, f"utt{i}.{fmt}")
                if not os.path.exists(path) or (fmt != "txt" and os.path.getsize(path) == 0):
                    fail(f"9: --output-format all did not write {path}")
        with open(os.path.join(tmp, "utt1.json")) as f:
            if "segments" not in json.load(f):
                fail("9: the json output has no segments")
        log("  9 --output-format all: txt, srt, vtt, tsv, json written for both files")

        # convert: an openai-format .pt of random tiny weights → npz → transcribe.
        cfg = EngineConfig(model="tiny", dtype="float32", max_new_tokens=24, language="en")
        params = init_params(cfg.dims(), torch.Generator().manual_seed(9))
        pt, npz = os.path.join(tmp, "tiny.pt"), os.path.join(tmp, "tiny.npz")
        torch.save({"dims": dataclasses.asdict(cfg.dims()), "model_state_dict": openai_state_dict(params)}, pt)
        _, _, wall_c, _ = _cli(["convert", "--checkpoint", pt, "--output", npz])
        stdout, stderr, wall_t, n = _cli(["transcribe", *wavs, "--checkpoint", npz, "--dtype", "float32",
                                          "--max-new-tokens", "24", "--language", "en", "--verbose"])
        _expect("9 tiny checkpoint", n, {"K1": 4}, bf16=False)
        with _torch_defaults(torch):  # as the subprocess runs: TF32 at torch's defaults
            engine = Monolith.from_assets(load_checkpoint(npz)[0], cfg, device="cuda")
            ref = engine.transcribe_files(wavs)
        want = "".join(r.text + "\n" for r in ref)
        got_lengths = [int(ln.split(", ")[-1].split(" ")[0]) for ln in stderr.splitlines()
                       if ln.startswith("  [")]
        if stdout != want or got_lengths != [r.length for r in ref]:
            fail(f"9: transcribe --checkpoint printed {stdout!r} (lengths {got_lengths}), the "
                 f"in-process engine {want!r} (lengths {[r.length for r in ref]})")
        log(f"  9 convert ({wall_c:.1f} s) + transcribe --checkpoint ({wall_t:.1f} s): text and lengths "
            f"equal to the in-process engine's ({[r.length for r in ref]}); launches {n}")
        record["checkpoint"] = {"wall_s": wall_t, "launches": n}
        stdout, _, _, _ = _cli(["info", npz])
        info = json.loads(stdout)
        if info["model"] != "tiny" or info["n_params"] != sum(x.numel() for x in leaves(params)):
            fail(f"9 info: {info}")
        log(f"  9 info: {info['model']}, {info['n_params']} parameters, {info['bytes']} bytes, {info['dtypes']}")
    return record


def phase_native(torch) -> dict:
    """Phase 10 (docstring): the native host loader and the C ABI."""
    import site

    import whisper_tpu_torch.native as native
    from whisper_tpu_torch.audio.wav import read_wav, write_wav
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.native.build import build_engine, build_host

    t0 = time.perf_counter()
    build_host(force=True)
    native.load_native.cache_clear()
    host = native.load_native()
    if host is None:
        fail("the native host library was built but load_native() returned None")
    log(f"  host library built in {time.perf_counter() - t0:.2f} s: {host.path}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, seconds in enumerate((4.0, 11.0, 19.5, 30.0, 2.0, 7.5, 25.0, 14.0)):
            p = os.path.join(tmp, f"u{i}.wav")
            write_wav(p, synthetic_utterance(seconds, 30 + i))
            paths.append(p)
        t0 = time.perf_counter()
        rows = host.load_batch(paths, max_len=480_000)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = np.zeros_like(rows)
        for i, p in enumerate(paths):
            samples = read_wav(p)
            ref[i, : len(samples)] = samples[:480_000]
        python_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(rows, ref):
            fail("the native load_batch differs from the Python readers")
        log(f"  load_batch of 8 WAVs ({rows.shape}): bitwise equal to the Python readers; native "
            f"{native_ms:.2f} ms, Python {python_ms:.2f} ms (host clock)")
        out.update(load_batch_ms=native_ms, python_read_ms=python_ms)

        cfg = EngineConfig(model="tiny", max_new_tokens=24)
        engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
        calls = []
        real = host.load_batch
        host.load_batch = lambda *a, **k: calls.append(1) or real(*a, **k)
        with_loader = engine.transcribe_files(paths)
        host.load_batch = real
        saved = native.load_native
        native.load_native = lambda: None
        try:
            without = engine.transcribe_files(paths)
        finally:
            native.load_native = saved
        if not calls:
            fail("transcribe_files did not read through the native loader")
        for a, b in zip(with_loader, without):
            if not np.array_equal(a.tokens, b.tokens) or a.text != b.text:
                fail("transcribe_files with the native loader differs from it without")
        log(f"  transcribe_files (tiny, 8 files) with the loader equals it without")

        t0 = time.perf_counter()
        built = build_engine(force=True)
        log(f"  C-ABI library and driver built in {time.perf_counter() - t0:.2f} s")
        config = json.dumps({
            "model": "tiny", "max_new_tokens": 24, "seed": 0, "device": "cuda",
            "pythonpath": ":".join([os.path.dirname(os.path.abspath(__file__)), *site.getsitepackages()]),
        })
        with _torch_defaults(torch):  # the C driver's interpreter runs at torch's defaults
            want = engine.transcribe(paths[1]).text
        t0 = time.perf_counter()
        proc = subprocess.run([built["driver"], config, paths[1]], capture_output=True, text=True,
                              timeout=300)
        driver_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the C driver exited {proc.returncode}: {proc.stderr[-2000:]}")
        if proc.stdout != want + "\n":
            fail(f"the C driver's text {proc.stdout!r} differs from the engine's {want!r}")
        log(f"  the C driver (a process that embeds Python) transcribed on cuda in {driver_s:.1f} s: "
            f"its text equals this process's engine's ({len(want)} characters)")
        out["driver_s"] = driver_s
    return out


BENCH_SMOKE = {"batch": 4, "max_new": 32, "repeats": 1}  # phase 11a: utils/bench cut to size


def phase_bench(torch, kernels, beam, bench, Monolith, flagship_assets) -> dict:
    """Phase 11a (docstring): ``utils/bench.run`` on phase 4b's weights,
    the flagship and then ``BENCH_BEAM=1``."""
    out = {}
    for label, beam_size in (("flagship", 5), ("greedy", 1)):
        k = {**bench.DEFAULTS, **BENCH_SMOKE, "beam": beam_size}
        cfg = bench.bench_config(k["model"], k["beam"], k["max_new"], k["dtype"], k["lang"], k["quant"],
                                 k["kv_dtype"], k["ctx_bucket"], k["fused"], k["audio_ctx"])
        engine = Monolith(flagship_assets, cfg, device="cuda")
        (record, results), wall, counts = _timed(torch, kernels, beam, lambda: bench.run(**k, engine=engine))
        encodes = 1 + k["repeats"] + max(k["repeats"], 3)  # warm-up, serialized, pipelined
        want = {"K1": LARGE_V3_ENC_LAYERS * encodes}
        if beam_size > 1:
            if counts["beam_steps"] == 0:
                fail(f"11a {label}: no beam step ran")
            want["K2"] = LARGE_V3_DEC_LAYERS * counts["beam_steps"]
        log(f"  11a {label}: {wall:.1f} s; launches {counts} ({encodes} encodes)")
        _expect(f"11a {label}", counts, want)
        plain = engine.transcribe_batch(bench.make_batch(k["batch"], k["audio_seconds"]))
        for a, b in zip(results, plain):
            if a.length != b.length or not np.array_equal(a.tokens, b.tokens):
                fail(f"11a {label}: the bench's last batch differs from a plain transcribe_batch: "
                     f"{a.tokens[:a.length].tolist()} vs {b.tokens[:b.length].tolist()}")
        check_results(results, engine, engine.dims.n_vocab)
        for key in ("mfu", "hbm_utilization"):
            v = record[key]
            if v is None or not (np.isfinite(v) and 0 < v <= 1.05):
                fail(f"11a {label}: {key} = {v}, expected within (0, 1.05]")
        log(f"  11a {label} record: {json.dumps(record)}")
        out[label] = {"record": record, "launches": counts}
    return out


def phase_bench_serving(torch, kernels, beam, bench_serving, EncDec, main_assets) -> dict:
    """Phase 11b (docstring): ``utils/bench_serving.run`` on phase 4's
    weights, its three front-ends."""
    flags = {"model": "large-v3", "n": 8, "slots": 4, "prefill_batch": 2, "max_new": 16, "dtype": "bfloat16"}
    cfg = bench_serving.serving_config(flags["model"], "en", flags["dtype"], flags["max_new"])
    engine = EncDec(main_assets, cfg, device="cuda")
    out, wall, counts = _timed(torch, kernels, beam,
                               lambda: bench_serving.run(**flags, engine=engine))
    p_len = len(engine._prompt)
    for name in bench_serving.FRONTENDS:
        fe = out[name]
        lens = [r.length - p_len for r in fe["results"]]
        log(f"  11b {name}: record {json.dumps(fe['record'])}; {fe['dispatches']} prefills or flushes, "
            f"K1 {fe['k1_launches']}")
        if fe["dispatches"] == 0 or fe["k1_launches"] != LARGE_V3_ENC_LAYERS * fe["dispatches"]:
            fail(f"11b {name}: K1 launched {fe['k1_launches']} times over {fe['dispatches']} dispatches")
        if len(lens) != flags["n"] or not all(1 <= n <= flags["max_new"] for n in lens):
            fail(f"11b {name}: tokens decoded per utterance {lens}, expected {flags['n']} within [1, 16]")
        check_results(fe["results"], engine, engine.dims.n_vocab)
    want = {"K1": sum(out[name]["k1_launches"] for name in bench_serving.FRONTENDS)}
    log(f"  11b: {wall:.1f} s; launches {counts}; speedup_disagg_vs_continuous "
        f"{out['speedup_disagg_vs_continuous']:.3f}")
    _expect("11b", counts, want)
    return {"records": {name: out[name]["record"] for name in bench_serving.FRONTENDS}, "launches": counts,
            "k1_per_frontend": {name: out[name]["k1_launches"] for name in bench_serving.FRONTENDS}}


ABLATE_SMOKE = ("large-v3", 4, 5, FP8, 4, "int8")  # phase 11c: model, batch, beam, kv, iterations, quant


def phase_ablate(torch, kernels, beam, ablate_step, gather_attend) -> dict:
    """Phase 11c (docstring): ``utils/ablate_step.run`` at large-v3, its
    reorders against each other and K3's row against its plain version."""
    model, batch, beam_size, kv, iters, quant = ABLATE_SMOKE
    ops = ablate_step.make_inputs(model, batch, beam_size, kv, quant, torch.device("cuda"))
    records, wall, counts = _timed(torch, kernels, beam, lambda: ablate_step.run(
        model, batch, beam_size, kv, iters, quant, inputs=ops, log=lambda s: log(f"  {s}")))
    by = {r["row"]: r for r in records}
    log(f"  11c: {wall:.1f} s; launches {counts}")
    for name in ("fused", "reorder_k4"):
        if name not in by:
            fail(f"11c: the {name} row did not run")
    for r in records:
        k3, k4 = r["k3_launches"] or 0, r["k4_launches"] or 0
        want3 = LARGE_V3_DEC_LAYERS * r["iterations"] if r["row"] == "fused" else 0
        want4 = 2 * r["iterations"] if r["row"] == "reorder_k4" else 0
        if (k3, k4) != (want3, want4):
            fail(f"11c {r['row']}: K3 {k3}, K4 {k4} launches, expected {want3}, {want4}")
    if "cross" not in by or not by["cross"]["iterations"]:
        fail("11c: the cross row did not run")
    _expect("11c", counts, {"K3": by["fused"]["k3_launches"], "K4": by["reorder_k4"]["k4_launches"],
                            "cross": LARGE_V3_DEC_LAYERS * by["cross"]["iterations"]})  # its layers.cross_attention_T calls

    # The reorders: bitwise equal to each other (launches here are checks, not counted).
    bk = batch * beam_size
    rot32 = ((torch.arange(bk, device=ops["ck"].device) + 1) % bk).to(torch.int32)
    cache = {"k": ops["ck"], "v": ops["cv"]}
    outs = {"index_select": ablate_step.reorder_index_select(cache, 0, rot32.long()),
            "one-hot": ablate_step.reorder_onehot(cache, 0, rot32.long()),
            "K4": ablate_step.reorder_k4(cache, 0, rot32)}
    if by["reorder_int8"]["not_run"] is None:
        outs["int8"] = ablate_step.reorder_int8(cache, 0, rot32.long())
    ref = outs["index_select"]
    signed_zeros = 0
    for name, got in outs.items():
        for n in ("k", "v"):
            a, b = got[n].view(torch.uint8), ref[n].view(torch.uint8)
            if name == "one-hot":
                # x·1 + 0·y turns −0 into +0: equal in value, and in bits but there.
                diff = a != b
                signed_zeros += int(diff.sum().item())
                if not (torch.equal(got[n].float(), ref[n].float()) and bool((b[diff] == 0x80).all())
                        and bool((a[diff] == 0).all())):
                    fail(f"11c: the one-hot reorder of {n} differs from index_select's beyond −0 → +0")
            elif not torch.equal(a, b):
                fail(f"11c: the {name} reorder of {n} differs from index_select's")
    log(f"  11c reorders equal to index_select's: {', '.join(outs)} bitwise, but the one-hot product's "
        f"{signed_zeros} bytes of −0 → +0; int8 product: {by['reorder_int8']['not_run'] or 'run'}")

    # One iteration of the fused row, each layer's K3 call against its plain
    # version on the same inputs (phase 3's rules: planes bitwise, 4 bf16 ulps).
    from whisper_tpu_torch.config import MODEL_DIMS

    h, pk, pv = ops["fq0"].clone(), ops["pk"].clone(), ops["pv"].clone()
    n_head, pos, worst = MODEL_DIMS[model].n_text_head, pk.shape[3] - 1, 0.0
    for layer in range(pk.shape[1]):
        rk, rv = pk.clone(), pv.clone()
        attn, pk, pv = gather_attend.fused_gather_attend(pk, pv, rot32, layer, pos, 0, h, h, h, n_head=n_head)
        want, rk, rv = gather_attend.fused_gather_attend_reference(rk, rv, rot32, layer, pos, 0, h, h, h,
                                                                   n_head=n_head)
        if not (torch.equal(pk.view(torch.uint8), rk.view(torch.uint8))
                and torch.equal(pv.view(torch.uint8), rv.view(torch.uint8))):
            fail(f"11c fused row, layer {layer}: K3's planes differ from its plain version's")
        err = (attn.float() - want.float()).abs().max().item()
        tol = bf16_tolerance(want.float().abs().max().item())
        if not err <= tol:
            fail(f"11c fused row, layer {layer}: attention {err} from the plain version (tolerance {tol})")
        worst = max(worst, err / tol)
        h = torch.tanh(attn).to(h.dtype)
    log(f"  11c fused row: {pk.shape[1]} layers, planes bitwise, attention within {worst:.2f} of the tolerance")
    return {"rows": records, "launches": counts}


@contextlib.contextmanager
def _torch_defaults(torch):
    """TF32 flags at torch's defaults while the ``with`` lasts (phase 5
    turns them off for the rest of the script)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


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


MOE_BATCH = 64  # phase 12: rows of the audio LM's batch, its decode's tokens
MOE_PREFILL = 64 * 232  # phase 12: tokens of the cell's longest prefill (64 rows × 232 positions)
MOE_BUDGET = 32  # phase 12b: new tokens a row
MOE_ROW_TOL = 5e-3  # phase 12a: per-row relative L2 error of the routed experts' output


def _moe_inputs(torch, audio_lm, dims, n: int, seed: int) -> tuple:
    """``n`` bf16 rows at the published width and their routing by a random
    f32 gate through ``models/audio_lm.route`` (top-p 0.7, at most 2, the
    null expert among the choices)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = dims.n_state
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate = torch.randn((d, dims.n_routed + dims.n_null), generator=gen, device="cuda") * d ** -0.5
    expert, weight, _, _ = audio_lm.route(gate, x, dims)
    return x, expert, weight


def _moe_bound_ms(counts: list, d: int, f: int) -> tuple:
    """The least time of the routed work: the larger of each touched
    expert's three matrices (bf16) plus each row's d inputs (bf16) and d
    outputs (f32) over the card's bandwidth, and 6·d·f FLOPs a row over its
    bf16 peak (``port_bench/common/moe_roofline``'s formula)."""
    touched, rows = sum(1 for c in counts if c), sum(counts)
    by_bytes = (touched * 3 * d * f * 2 + rows * d * 6) / PEAK_BYTES * 1e3
    by_ops = rows * 6 * d * f / PEAK_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _moe_composite(torch, x, expert, weight, wg, wu, wd):
    """The nearest library composite (bf16 products of each expert's rows,
    PyTorch's own kernels): index lists made on the host first, so the
    timed call does no host read."""
    e = wg.shape[0]
    k = expert.shape[1]
    idx = [(expert.reshape(-1) == i).nonzero()[:, 0] for i in range(e)]
    toks = [(p // k, weight.reshape(-1)[p].to(torch.bfloat16)[:, None]) for p in idx]

    def run():
        y = torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
        for i, (t, w) in enumerate(toks):
            if t.numel():
                xe = x[t]
                h = torch.nn.functional.silu(xe @ wg[i]) * (xe @ wu[i])
                y.index_add_(0, t, (h @ wd[i]) * w)
        return y

    return run


def _synced_ms(torch, fn, reps: int = 3) -> float:
    """Wall ms of one call of ``fn`` that reads the card from the host (the
    plain version: ``nonzero``), synchronised before and after; median."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _moe_kernel_ms(torch, moe_expert, fn) -> dict:
    """Device ms of each ``moe_expert*`` kernel of one call of ``fn``
    (profiler, one traced call after a warm one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.name.startswith(moe_expert.KERNEL_SYMBOL):
            out[ev.name] = out.get(ev.name, 0.0) + ev.device_time_total / 1e3
    return out


def phase_moe_kernels(torch, moe_expert, audio_lm, dims, sweep: bool) -> dict:
    """Phase 12a: the routed experts' kernels against their plain version on
    the same card tensors, at the decode's shape (64 tokens) and the
    cell's longest prefill (14,848 tokens), each row of y within
    ``MOE_ROW_TOL`` (relative L2) of the plain version's, rows routed
    nowhere exactly 0, the counts equal; then a wrong routing (one
    routed expert's rows dropped) must fail the same test. Times: the
    wrapper, each kernel (profiler), the plain version, the nearest
    library composite and the bound. ``sweep``: every pair of variants
    of the kernel table at both shapes."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    d, f, e = dims.n_state, dims.routed_width, dims.n_routed

    def w(shape, fan):
        return (torch.randn(shape, generator=gen, device="cuda") * fan ** -0.5).to(torch.bfloat16)

    wg, wu, wd = w((e, d, f), d), w((e, d, f), d), w((e, f, d), f)
    rec = {"name": "moe_expert", "route": "cuda", "source": "whisper_tpu_torch/csrc/moe_expert.cu",
           "replaces": None, "bound_by": {}, "launches": None}
    for label, n, seed in (("decode", MOE_BATCH, 1), ("prefill", MOE_PREFILL, 2)):
        x, expert, weight = _moe_inputs(torch, audio_lm, dims, n, seed)
        before = moe_expert.launches
        y, counts = moe_expert.moe_experts(x, expert, weight, wg, wu, wd)
        torch.cuda.synchronize()
        if moe_expert.launches != before + 2:
            fail(f"MoE {label}: {moe_expert.launches - before} launches counted, expected 2")
        y_ref, counts_ref = moe_expert.moe_experts_reference(x, expert, weight, wg, wu, wd)
        routed = (expert < e).any(1)
        err = ((y - y_ref).norm(dim=1) / y_ref.norm(dim=1).clamp(min=1e-30))[routed].max().item()
        if counts.tolist() != counts_ref.tolist() or err > MOE_ROW_TOL or bool(y[~routed].any()):
            fail(f"MoE {label}: counts {counts.tolist()} against {counts_ref.tolist()}, "
                 f"worst row error {err:.3g} (limit {MOE_ROW_TOL}), rows routed nowhere non-zero: "
                 f"{bool(y[~routed].any())}")
        # The same test must catch a kernel that leaves one expert's rows out.
        wrong = torch.where(expert == int(counts.argmax()), e, expert)
        y_bad, _ = moe_expert.moe_experts(x, wrong, weight, wg, wu, wd)
        bad = ((y_bad - y_ref).norm(dim=1) / y_ref.norm(dim=1).clamp(min=1e-30))[routed].max().item()
        if bad <= MOE_ROW_TOL:
            fail(f"MoE {label}: an expert's rows left out reads {bad:.3g}, within the limit")
        cnt = counts.tolist()
        bound, by = _moe_bound_ms(cnt, d, f)

        def call(x=x, expert=expert, weight=weight):
            return moe_expert.moe_experts(x, expert, weight, wg, wu, wd)

        per_kernel = _moe_kernel_ms(torch, moe_expert, call)
        ms = time_ms(call, inner=10 if label == "decode" else 2, reps=5 if label == "decode" else 3)
        plain_ms = _synced_ms(torch, lambda: moe_expert.moe_experts_reference(x, expert, weight, wg, wu, wd),
                              reps=1 if label == "prefill" else 3)
        lib_ms = time_ms(_moe_composite(torch, x, expert, weight, wg, wu, wd), inner=2, reps=3)
        log(f"  MoE {label} ({n} tokens, rows {cnt}): worst row error {err:.3g} (an expert left out: "
            f"{bad:.3g}); kernels {ms:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in per_kernel.items())}), "
            f"plain (f32) {plain_ms:.4f} ms, library composite (bf16 matmuls + index_add) {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}): {100 * bound / ms:.1f}%")
        rec[label] = {"tokens": n, "rows": cnt, "max_row_err": err, "ms": ms, "kernel_ms": per_kernel,
                      "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}
        if sweep:
            small = n * expert.shape[1] <= moe_expert.SMALL
            keep = moe_expert.VARIANTS[small]
            gated = [v for v in range(16) if _variant_or_none(moe_expert, v) and moe_expert.variant(v)[0]]
            down = [v for v in range(16) if _variant_or_none(moe_expert, v) and not moe_expert.variant(v)[0]]
            times = {}
            for vg in gated:
                for vd in down:
                    moe_expert.VARIANTS[small] = (vg, vd)
                    try:
                        times[f"{vg},{vd}"] = _moe_kernel_ms(torch, moe_expert, call)
                    except (ValueError, RuntimeError) as ex:
                        times[f"{vg},{vd}"] = str(ex)
            moe_expert.VARIANTS[small] = keep
            log(f"  MoE {label} sweep (gate/up, down variants → kernel ms): {json.dumps(times)}")
            rec[label]["sweep"] = times
        del x, expert, weight, y, y_ref, y_bad
    rec["ms"], rec["bound_ms"], rec["plain_ms"], rec["library_ms"] = (
        rec["decode"]["ms"], rec["decode"]["bound_ms"], rec["decode"]["plain_ms"], rec["decode"]["library_ms"])
    return rec


def _variant_or_none(moe_expert, v: int) -> bool:
    try:
        moe_expert.variant(v)
        return True
    except ValueError:
        return False


def moe_utterances(n: int = MOE_BATCH) -> list:
    """``n`` clips with lengths spread evenly over 4–20 s."""
    return [synthetic_utterance(4.0 + 16.0 * i / (n - 1), i % 7) for i in range(n)]


def phase_moe_path(torch, moe_expert, audio_lm, greedy, graph, EngineConfig, EngineType,
                   create_engine) -> dict:
    """Phase 12b: Uni-MoE-2.0-Omni's main path at the published widths:
    ``create_engine(MONOLITH, EngineConfig(model="uni-moe-2.0-omni",
    max_new_tokens=MOE_BUDGET, ...))`` with random weights, then
    ``transcribe_batch`` of 64 clips of 4–20 s, twice, each with the
    launch counts set to 0 just before and read just after: the routed
    experts' wrapper must count 2 launches per layer of the prefill and
    of every step (graph replays included), every step after the warm ones
    replayed; the second run under the profiler, whose ``moe_expert*``
    kernels must equal that run's count; both runs' tokens equal (the
    kernels' sums do not depend on the order of their atomics) and well
    formed."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.config import AUDIO_LM_DIMS

    dims = AUDIO_LM_DIMS["uni-moe-2.0-omni"]
    cfg = EngineConfig(model="uni-moe-2.0-omni", max_new_tokens=MOE_BUDGET,
                       lm_prefix_tokens=tuple(range(100, 116)), lm_suffix_tokens=tuple(range(200, 216)))
    t0 = time.perf_counter()
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  engine with random weights in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    utts = moe_utterances()
    engine.transcribe_batch(utts)  # warm: the captures of the step
    runs = []
    for traced in (False, True):
        torch.cuda.synchronize()
        moe_expert.launches, steps0, replays0 = 0, greedy.steps, graph.replays
        t0 = time.perf_counter()
        if traced:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                results = engine.transcribe_batch(utts)
                torch.cuda.synchronize()
        else:
            results = engine.transcribe_batch(utts)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, steps, replays = moe_expert.launches, greedy.steps - steps0, graph.replays - replays0
        if launches != 2 * dims.n_layer * (1 + steps):
            fail(f"MoE path: {launches} launches for {steps} steps, expected {2 * dims.n_layer * (1 + steps)}")
        if replays != steps:
            fail(f"MoE path: {replays} of {steps} steps replayed")
        rec = {"wall_s": wall, "launches": launches, "steps": steps, "replays": replays}
        if traced:
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and ev.name.startswith(moe_expert.KERNEL_SYMBOL)]
            if len(names) != launches:
                fail(f"MoE path: {len(names)} moe_expert kernels in the trace, {launches} counted")
            rec["traced_kernels"] = len(names)
        for r in results:
            toks = np.asarray(r.tokens)
            if (toks.shape != (MOE_BUDGET,) or not 1 <= r.length <= MOE_BUDGET or toks.min() < 0
                    or toks.max() >= dims.n_vocab or (toks[r.length:] != dims.stop).any()):
                fail(f"MoE path: malformed result {toks[:8]}…, length {r.length}")
        runs.append(([np.asarray(r.tokens) for r in results], rec))
        log(f"  MoE path run {'traced' if traced else 'untraced'}: {wall:.2f} s, {steps} steps "
            f"({replays} replayed), moe_expert launches {launches}"
            + (f", {rec['traced_kernels']} moe_expert kernels in the trace" if traced else ""))
    if not all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0])):
        fail("MoE path: two runs of the same batch gave different tokens")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  MoE path: both runs' tokens equal; max_memory_allocated {peak:.2f} GB")
    del engine
    return {"untraced": runs[0][1], "traced": runs[1][1], "peak_gb": peak}


def moe_only(sweep: bool) -> None:
    """``--moe [--sweep]``: phases 1, 2 (the routed experts' kernels only)
    and 12; the last line is the kernels' JSON record."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import graph, greedy
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.models import audio_lm
    from whisper_tpu_torch.ops import build, moe_expert

    log(f"[1] card: {card_line()}")
    t0 = time.perf_counter()
    for name, (secs, ptxas) in build.build([moe_expert.KERNEL]).items():
        usage = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[2] {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": [phase_moe(torch, moe_expert, audio_lm, greedy, graph, EngineConfig,
                                            EngineType, create_engine, sweep)]}))


def phase_moe(torch, moe_expert, audio_lm, greedy, graph, EngineConfig, EngineType, create_engine,
              sweep: bool = False) -> dict:
    from whisper_tpu_torch.config import AUDIO_LM_DIMS

    log("[12a] the routed experts' kernels against their plain version: Uni-MoE-2.0-Omni's widths")
    rec = phase_moe_kernels(torch, moe_expert, audio_lm, AUDIO_LM_DIMS["uni-moe-2.0-omni"], sweep)
    log("[12b] Uni-MoE-2.0-Omni's main path: 64 clips of 4-20 s, greedy, bf16, random weights")
    path = phase_moe_path(torch, moe_expert, audio_lm, greedy, graph, EngineConfig, EngineType,
                          create_engine)
    rec["launches"] = path["untraced"]["launches"]
    rec["path"] = path
    return rec


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
    if sys.argv[1:2] == ["--cross"]:
        return cross_only()
    if sys.argv[1:2] == ["--moe"]:
        return moe_only("--sweep" in sys.argv[2:])
    if sys.argv[1:2] == ["--sweep-tree"]:
        return sweep_tree(sys.argv[2])
    if sys.argv[1:2] == ["--k1-tree"]:
        return k1_tree(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    t_start = time.perf_counter()
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import beam
    from whisper_tpu_torch.engine import EncDec, EngineType, Monolith, create_engine
    from whisper_tpu_torch.frontend import mel_fused
    from whisper_tpu_torch.ops import attention, build, fp8_upcast, fused_step, gather, gather_attend
    from whisper_tpu_torch.utils import ablate_step, bench, bench_serving, probe_cross, probe_fused

    CROSS.install()
    log("[1] card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}; capability {cap}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    log("[2] build")
    t0 = time.perf_counter()
    kernels = (attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast)
    built = build.build([k.KERNEL for k in kernels] + ["moe_expert", "cross_attend"])
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
    k6 = phase_fp8_upcast(torch, fp8_upcast)

    log("[4] main path: large-v3, greedy, bf16, language detection")
    k1["launches"], main_engine, main_results, cross_greedy = phase_main_path(
        torch, kernels, EngineConfig, EngineType, create_engine
    )

    log("[4b] beam main path: large-v3, beam 5, int8 weights, fp8 KV cache, bf16")
    k2["launches"], k4["launches"], beam_engine, beam_results, cross_beam = phase_beam_path(
        torch, kernels, beam, EngineConfig, EngineType, create_engine
    )
    phase_quantize_witness(torch, main_engine, beam_engine)
    main_assets, flagship_assets = main_engine.assets, beam_engine.assets  # phase 11's weights

    log("[4c] K3's path: probe_fused at large-v3, batch 4, beam 5, ctx 68, fp8 planes")
    k3["launches"] = phase_probe_fused(torch, kernels, probe_fused)

    log("[4d] data-parallel path: large-v3, beam 5, int8, fp8 KV, mesh_shape=(2, 1), two ranks on one card")
    per_rank, cross_dp = phase_data_parallel(torch, beam_engine, beam_results)
    k2s["launches"], k2s["launches_per_rank"] = sum(per_rank), per_rank

    t4e = time.perf_counter()
    log("[4e] tensor-parallel path: large-v3 bf16, mesh_shape=(1, 2), two ranks on one card over gloo, "
        "each restored from an npz of phase 4's weights")
    tp = phase_tensor_parallel(torch, main_engine, beam_engine)
    k1["tp_launches_per_rank"] = {label: rec["k1_per_rank"] for label, rec in tp.items()}
    k4["tp_launches_per_rank"] = {label: rec["k4_per_rank"] for label, rec in tp.items()}
    k1["tp_local_heads"]["launches_per_rank"] = k1["tp_launches_per_rank"]
    log(f"  phase 4e took {time.perf_counter() - t4e:.1f} s")

    t4f = time.perf_counter()
    log("[4f] the batch stream: transcribe_batches against a loop of transcribe_batch, large-v3, "
        "greedy bf16 and the flagship")
    stream = phase_batch_stream(torch, kernels, beam, main_engine, beam_engine)
    for name, rec in zip(("K1", "K2", "K2′", "K3", "K4", "K5", "K6"), (k1, k2, k2s, k3, k4, k5, k6)):
        rec["stream_launches"] = {label: r["launches"][name] for label, r in stream.items()}
    log(f"batch stream record: {json.dumps(stream)}; phase 4f took {time.perf_counter() - t4f:.1f} s")

    t4g = time.perf_counter()
    log(f"[4g] K6's path: probe_cross at large-v3, batch 16, beam 5, Tk 1500, fp8, {PROBE_CROSS_ITERS} "
        "iterations, in its six modes; then beam 1, bf16, in bf16 and kernel")
    cross = phase_probe_cross(torch, kernels, probe_cross)
    k6["launches"] = cross["k6_launches"]
    k6["probe_launches"] = {mode: rec["launches"]["K6"] for mode, rec in cross["records"].items()}
    k6["probe"] = {mode: {key: rec[key] for key in ("ms_per_iter", "moved_gb", "launches_per_iter")}
                   for mode, rec in cross["records"].items()}
    k6["engine_launches"] = {"greedy": 0, "beam": 0}  # phases 4 and 4b fail on any other count
    log(f"probe_cross record: {json.dumps(cross['records'])}; turbo: {json.dumps(cross['turbo'])}; "
        f"phase 4g took {time.perf_counter() - t4g:.1f} s")

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
    for rec in (k2s, k3, k4, k5, k6):
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
    log(f"options record: {json.dumps(options)}; phase 7 took {time.perf_counter() - t7:.1f} s")

    t8 = time.perf_counter()
    log("[8] speculative decoding: 8a large-v3 f32 (TF32 off), three drafts against greedy; "
        "8b bf16 (phase 4's weights) with a distil-large-v3 draft")
    spec = phase_speculative(torch, kernels, beam, main_engine, main_results)
    del main_engine
    log(f"speculative record: {json.dumps(spec)}; phase 8 took {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    log("[9] the CLI: python -m whisper_tpu_torch.cli on the card")
    cli = phase_cli(torch)
    log(f"CLI record: {json.dumps(cli)}; phase 9 took {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    log("[10] the native host loader and the C ABI")
    native_rec = phase_native(torch)
    log(f"native record: {json.dumps(native_rec)}; tensor-parallel record: {json.dumps(tp)}; "
        f"phase 10 took {time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()
    log("[11a] utils/bench on the flagship (phase 4b's weights): batch 4, 32 tokens, 1 repeat; then BENCH_BEAM=1")
    bench_rec = phase_bench(torch, kernels, beam, bench, Monolith, flagship_assets)
    log("[11b] utils/bench_serving: large-v3 greedy bf16 (phase 4's weights), --n 8 --slots 4 "
        "--prefill-batch 2 --max-new 16, its three front-ends")
    serving_rec = phase_bench_serving(torch, kernels, beam, bench_serving, EncDec, main_assets)
    del main_assets, flagship_assets
    log(f"[11c] utils/ablate_step: {' '.join(str(a) for a in ABLATE_SMOKE)} (model, batch, beam, kv, "
        "iterations, quant)")
    ablate_rec = phase_ablate(torch, kernels, beam, ablate_step, gather_attend)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s")

    t12 = time.perf_counter()
    from whisper_tpu_torch.decode import graph, greedy
    from whisper_tpu_torch.models import audio_lm
    from whisper_tpu_torch.ops import moe_expert

    moe = phase_moe(torch, moe_expert, audio_lm, greedy, graph, EngineConfig, EngineType, create_engine)
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")

    t13 = time.perf_counter()
    from whisper_tpu_torch.ops import cross_attend

    cross_rec = phase_cross(torch, cross_attend)
    log(f"cross-attention record: {json.dumps(cross_rec)}; phase 13 took {time.perf_counter() - t13:.1f} s")

    xa = cross_kernel_record(cross_rec, cross_greedy, cross_beam, cross_dp, tp, stream, serving, cross)
    names = ("K1", "K2", "K2′", "K3", "K4", "K5", "K6", "cross")
    for name, rec in zip(names, (k1, k2, k2s, k3, k4, k5, k6, xa)):
        rec["tools_launches"] = {
            "11a_flagship": bench_rec["flagship"]["launches"][name],
            "11a_greedy": bench_rec["greedy"]["launches"][name],
            "11b": serving_rec["launches"][name], "11c": ablate_rec["launches"][name],
        }
        rec["options_launches"] = {
            "7a": options["7a"]["launches"][name], "7b": options["7b"]["launches"][name],
            "7c": options["7c"]["launches"][name], "7d_long": options["7d"]["long_launches"][name],
            "7d_sequential": options["7d"]["sequential_launches"][name],
        }
        rec["speculative_launches"] = {key: r["launches"][name] for key, r in spec.items()}
        rec["cli_launches"] = {key: r["launches"][name] for key, r in cli.items()}
    k1["f32"]["launches"] = spec["8a_greedy"]["launches"]["K1"]  # the f32 main path: 8a's greedy batch

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k2s, k3, k4, k5, k6, moe, xa]}))
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
