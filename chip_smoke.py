#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisper_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. Card: name and power limit (nvidia-smi), compute capability (must be 9.0).
2. Build: every kernel of the main path, with nvcc from the sources in
   ``whisper_tpu_torch/csrc/`` (into ``build/whisper_tpu_torch/``).
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes and a few others, with the tolerance stated; times of the
   kernel, the plain version and the library call beside the bound.
4. Main path at full width: ``create_engine(MONOLITH, EngineConfig(
   model="large-v3", max_new_tokens=64), device="cuda")`` with random
   weights from a seed; ``transcribe_batch`` of 4 utterances of different
   lengths and ``transcribe`` of a WAV file. Launch counts are set to 0
   just before and read just after: K1 must run once per encoder layer of
   every encode. Prints audio-s/s, encoder ms and decode ms/token.
5. Kernel path against the CPU path end to end: ``tiny`` dims in float32,
   TF32 off for matmuls and cuDNN, the same weights on the card and on the
   CPU must give equal tokens for a batch of 2.

Then, each on a line of its own: the kernels' JSON record, the card's name
and power limit, and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def phase_main_path(torch, attention, EngineConfig, EngineType, create_engine) -> int:
    from whisper_tpu_torch.audio.wav import write_wav

    cfg = EngineConfig(model="large-v3", max_new_tokens=64)
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    dims = engine.dims
    lengths_s = (4.0, 11.0, 19.5, 30.0)
    utts = [synthetic_utterance(s, i) for i, s in enumerate(lengths_s)]
    batch = np.zeros((4, 480_000), np.float32)
    for i, u in enumerate(utts):
        batch[i, : len(u)] = u
    audio_s = float(sum(lengths_s))

    attention.launches = 0  # counts start here: the main path's run
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
    tokens, lengths, _ = engine._decode(enc_out)
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


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    t_start = time.perf_counter()
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
    from whisper_tpu_torch.ops import attention, build

    log("[1] card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}; capability {cap}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    log("[2] build")
    t0 = time.perf_counter()
    built = build.build([attention.KERNEL])
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (secs, ptxas) in built.items():
        usage = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(usage))

    log("[3] kernels against their plain versions")
    record = phase_kernels(torch, attention)

    log("[4] main path: large-v3, greedy, bf16, language detection")
    record["launches"] = phase_main_path(torch, attention, EngineConfig, EngineType, create_engine)

    log("[5] card against CPU: tiny, float32, TF32 off")
    phase_card_vs_cpu(torch, EngineConfig, Monolith)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
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
