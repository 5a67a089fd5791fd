"""The port's headline benchmark: one JSON line of audio-s/s through the public engine path.

    python3 -m whisper_tpu_torch.utils.bench        # BENCH_* knobs from the environment

Counterpart of ``bench.py`` (the JAX package's harness), with the same
``BENCH_*`` knobs read the same way and with the same defaults, so that
``BENCH_MODEL=tiny BENCH_BEAM=1 python3 -m whisper_tpu_torch.utils.bench``
means what ``python bench.py`` means under the same environment:

  BENCH_MODEL   (large-v3)   BENCH_BATCH   (16)    BENCH_MAX_NEW (224)
  BENCH_BEAM    (5)          BENCH_QUANT   (int8)  BENCH_KV (float8_e4m3fn)
  BENCH_DTYPE   (bfloat16)   BENCH_REPEATS (3)     BENCH_LANG (en)
  BENCH_AUDIO_CTX (auto)     BENCH_AUDIO_SECONDS (30)
  BENCH_FUSED (auto: the port's beam step modes auto|hybrid|lineage|off,
               or 1/true for "hybrid")
  BENCH_CTX_BUCKET (auto; passed to the config and the roofline as JAX
               does: the port decodes into one preallocated cache, so the
               engine accepts it and ignores it)

"none" turns BENCH_QUANT, BENCH_KV and BENCH_AUDIO_CTX off. Weights are
random from seed 0 (throughput does not depend on their values; random
logits almost never give EOT, so every row decodes the whole budget). The
batch is bench.py's: ``default_rng(1)``, ``0.1 · standard_normal`` over
the first BENCH_AUDIO_SECONDS of each 30 s row, zeros after.

Method (bench.py's): ``create_engine(MONOLITH)``; one warm-up
``transcribe_batch`` (the kernels' build, the allocator's first blocks and
the libraries' set-up excluded); BENCH_REPEATS serialized runs (median and
min); ``transcribe_batches`` of ``max(BENCH_REPEATS, 3)`` copies of the
batch (the double-buffered stream); the faster of the serialized median
and the pipelined seconds per batch gives ``value``, and ``value_basis``
says which. Every clock is read once the results are on the host. ``mfu``
and ``hbm_utilization`` come from ``utils/roofline.utilization`` at the
H100 SXM's peaks (989 TFLOP/s bf16, 3.35 TB/s) on the resolved crop.

The JSON line has bench.py's keys but ``vs_baseline`` and
``config.baseline`` (a TPU number is no target of the port); its
``config.device`` is the card's name and ``config.card`` the card's name
and power limit (nvidia-smi). :func:`run` is the entry point for scripts
and tests: it takes an engine (tests hand in one built on the JAX
package's weights) and otherwise builds one on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.utils.roofline import utilization

N_SAMPLES = 480_000
ENGINE = "monolith (create_engine path: rules, detokenize, host transfer included)"


def _opt(environ: Mapping[str, str], name: str, default: str) -> Optional[str]:
    v = environ.get(name, default)
    return None if v in ("", "none", "None") else v


def knobs(environ: Optional[Mapping[str, str]] = None) -> dict:
    """The ``BENCH_*`` knobs of ``environ`` (default ``os.environ``), parsed
    as ``bench.py:31-62`` parses them, as :func:`run`'s keyword arguments."""
    env = os.environ if environ is None else environ
    ac = _opt(env, "BENCH_AUDIO_CTX", "auto")
    fused = env.get("BENCH_FUSED", "auto")
    if fused not in ("auto", "lineage", "hybrid", "off"):
        fused = fused in ("1", "true", "True")
    cb = env.get("BENCH_CTX_BUCKET", "auto")
    if cb in ("none", "None", "0"):
        ctx_bucket = None
    elif cb in ("auto", ""):
        ctx_bucket = "auto"
    else:
        ctx_bucket = int(cb)
    return {
        "model": env.get("BENCH_MODEL", "large-v3"),
        "batch": int(env.get("BENCH_BATCH", "16")),
        "max_new": int(env.get("BENCH_MAX_NEW", "224")),
        "repeats": int(env.get("BENCH_REPEATS", "3")),
        "beam": int(env.get("BENCH_BEAM", "5")),
        "dtype": env.get("BENCH_DTYPE", "bfloat16"),
        "lang": env.get("BENCH_LANG", "en"),
        "quant": _opt(env, "BENCH_QUANT", "int8"),
        "kv_dtype": _opt(env, "BENCH_KV", "float8_e4m3fn"),
        "audio_ctx": "auto" if ac == "auto" else (int(ac) if ac else None),
        "audio_seconds": float(env.get("BENCH_AUDIO_SECONDS", "30")),
        "fused": fused,
        "ctx_bucket": ctx_bucket,
    }


DEFAULTS = knobs({})


def bench_config(
    model: str, beam: int, max_new: int, dtype: str, lang: str, quant, kv_dtype,
    ctx_bucket, fused, audio_ctx,
) -> EngineConfig:
    """bench.py's ``EngineConfig``: the language pinned on a multilingual
    model, none on an English-only one."""
    return EngineConfig(
        model=model, language=lang if MODEL_DIMS[model].multilingual else None,
        beam_size=beam, max_new_tokens=max_new, dtype=dtype, quantization=quant,
        kv_cache_dtype=kv_dtype, ctx_bucket=ctx_bucket, fused_step=fused, audio_ctx=audio_ctx,
    )


def make_batch(batch: int, audio_seconds: float) -> np.ndarray:
    """bench.py's synthetic batch [batch, 480000] float32: seed 1,
    ``0.1 · standard_normal`` over the content, zeros after it."""
    rng = np.random.default_rng(1)
    n_content = min(N_SAMPLES, int(audio_seconds * 16_000))
    out = np.zeros((batch, N_SAMPLES), np.float32)
    out[:, :n_content] = (0.1 * rng.standard_normal((batch, n_content))).astype(np.float32)
    return out


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    """What the record names the device: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def run(
    model: str = DEFAULTS["model"], batch: int = DEFAULTS["batch"],
    max_new: int = DEFAULTS["max_new"], repeats: int = DEFAULTS["repeats"],
    beam: int = DEFAULTS["beam"], dtype: str = DEFAULTS["dtype"], lang: str = DEFAULTS["lang"],
    quant=DEFAULTS["quant"], kv_dtype=DEFAULTS["kv_dtype"], audio_ctx=DEFAULTS["audio_ctx"],
    audio_seconds: float = DEFAULTS["audio_seconds"], fused=DEFAULTS["fused"],
    ctx_bucket=DEFAULTS["ctx_bucket"], *, engine=None, device: str = "cuda",
) -> tuple:
    """bench.py's measurement (module docstring). ``engine``: a Monolith
    whose config is :func:`bench_config` of these arguments (its weights
    and device are used as they are); None builds one from random weights
    (seed 0) on ``device``, which must exist. Returns (the record, the
    last pipelined batch's results)."""
    config = bench_config(model, beam, max_new, dtype, lang, quant, kv_dtype, ctx_bucket, fused,
                          audio_ctx)
    if engine is None:
        engine = create_engine(EngineType.MONOLITH, config, seed=0, device=device)
    elif engine.config != config:
        raise ValueError(f"bench: the engine's config {engine.config} is not the knobs' {config}")
    dims = engine.dims
    host = make_batch(batch, audio_seconds)

    engine.transcribe_batch(host)  # warm-up: excluded
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        results = engine.transcribe_batch(host)
        times.append(time.perf_counter() - t0)
    if len(results) != batch:
        raise RuntimeError(f"bench: {len(results)} results for a batch of {batch}")
    ser_median, ser_min = float(np.median(times)), float(min(times))

    n_pipe = max(repeats, 3)
    t0 = time.perf_counter()
    res_lists = engine.transcribe_batches([host] * n_pipe)
    pipe_s = (time.perf_counter() - t0) / n_pipe
    if len(res_lists) != n_pipe or len(res_lists[-1]) != batch:
        raise RuntimeError("bench: transcribe_batches returned a malformed result list")
    results = res_lists[-1]

    audio_seconds_total = batch * audio_seconds
    if pipe_s <= ser_median:
        value, value_basis = audio_seconds_total / pipe_s, "pipelined"
    else:
        value, value_basis = audio_seconds_total / ser_median, "serialized_median"

    prepared, _, _ = engine._prepare_batch(host)
    resolved_ac = engine._resolve_audio_ctx(prepared)
    p_len = len(engine._prompt)
    roofline = utilization(
        dims, batch=batch, beam=beam, p_len=p_len, new_tokens=float(max_new),
        total_len=p_len + max_new, wall_s=min(pipe_s, ser_median), quant=quant,
        kv_dtype=kv_dtype, device_kind=device_name(engine.device), ctx_bucket=ctx_bucket,
        audio_ctx=resolved_ac,
    )
    record = {
        "metric": "audio-seconds/s per chip",
        "value": value,
        "unit": "audio-s/s",
        "value_basis": value_basis,
        "mfu": roofline.get("mfu"),
        "hbm_utilization": roofline.get("hbm_utilization"),
        "roofline": roofline,
        "config": {
            "model": model,
            "engine": ENGINE,
            "batch": batch,
            "max_new_tokens": max_new,
            "beam": beam,
            "quant": quant,
            "kv_dtype": kv_dtype,
            "dtype": dtype,
            "ctx_bucket": ctx_bucket,
            "tokens_decoded": int(sum(r.length for r in results)),
            "device": device_name(engine.device),
            "card": card_line() if engine.device.type == "cuda" else None,
            "times_s": times,
            "serialized_median_s": ser_median,
            "serialized_min_s": ser_min,
            "pipelined_s_per_batch": pipe_s,
            "fused_step": str(config.fused_step),
            "audio_transfer_dtype": config.audio_transfer_dtype,
            "audio_seconds_per_utt": audio_seconds,
            "audio_ctx": str(audio_ctx),
            "audio_ctx_resolved": resolved_ac,
        },
    }
    return record, results


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("bench: needs a CUDA card (torch.cuda.is_available() is false)")
    record, _ = run(**knobs())
    print(json.dumps(record))


if __name__ == "__main__":
    main()
