"""Offline transcription: whole batches through ``Monolith.transcribe_batch``
in a closed loop, one after the other.

Traffic keys: ``rows`` per batch; ``clip_seconds`` [lo, hi] (each batch
is the frozen ``make_batch``'s signal at ``hi``, its rows cut to lengths
spread evenly over [lo, hi] in an order drawn from the seed and
zero-padded to the longest); ``max_new_tokens``;
``audio_ctx``; ``pool`` (distinct batches drawn from the seed, used in
turn); ``judge_requests`` (rows the reference judges); ``warm`` (default
true: one batch of the window's shapes before it; ``calibrate.py`` turns
it off where it reads only correctness).

A batch is started only while the mean batch time so far says it ends
inside the window, so the window holds whole batches only. With ``trace``
the first batch is profiled (the slice) and the rest run untraced, at
least one of them, whose times the window's rates read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.common import frozen
from port_bench.common.stats import whole_window_rate
from port_bench.common.trace import Slice
from port_bench.drivers.common import decode_steps, engine_config, rng
from port_bench.reference.whisper import auto_audio_ctx, int16_grid


def _pool(traffic: dict, seed: int) -> list:
    rows = traffic["rows"]
    lo, hi = traffic["clip_seconds"]
    lengths = np.linspace(lo, hi, rows)
    out = []
    for i in range(traffic["pool"]):
        r = rng(seed, 100 + i)
        batch = frozen.make_batch(rows, hi, seed=int(r.integers(1 << 62)))
        n = (r.permutation(lengths) * 16_000).astype(int)
        batch = batch[:, : int(n.max())]
        for j, nj in enumerate(n):
            batch[j, nj:] = 0.0
        out.append({"audio": int16_grid(batch), "content_s": float(lengths.sum())})
    return out


def setup(run) -> dict:
    from whisper_tpu_torch.engine import EngineType, create_engine

    cfg = engine_config(run.config, run.traffic, **run.engine_overrides)
    engine = create_engine(EngineType.MONOLITH, cfg, params=run.params, device=run.device)
    pool = _pool(run.traffic, run.seed)
    if run.traffic.get("warm", True):
        engine.transcribe_batch(pool[-1]["audio"])  # warm-up: the window's shapes
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"engine": engine, "pool": pool}


def _stage_s(engine) -> float:
    stats = engine.timer.summary()
    return sum(stats[k].total_s for k in ("model", "mel") if k in stats)


def measure(run, state: dict, seconds: float, trace: bool) -> dict:
    engine, pool = state["engine"], state["pool"]
    beam = engine.config.beam_size
    batches = []
    slice_rec = None
    t_start = time.perf_counter()
    while True:
        done = [b for b in batches if not b["traced"]]
        if done:  # a traced run times one batch untraced whatever the window
            mean = sum(b["t1"] - b["t0"] for b in done) / len(done)
            if time.perf_counter() - t_start + mean > seconds:
                break
        item = pool[len(batches) % len(pool)]
        traced = trace and not batches
        steps0, stage0 = decode_steps(), _stage_s(engine)
        t0 = time.perf_counter()
        if traced:
            with Slice() as sl:
                results = engine.transcribe_batch(item["audio"])
            slice_rec = sl
        else:
            results = engine.transcribe_batch(item["audio"])
        t1 = time.perf_counter()
        batches.append({
            "t0": t0, "t1": t1, "traced": traced, "item": item, "results": results,
            "steps": decode_steps() - steps0,
            "host_s": (t1 - t0) - (_stage_s(engine) - stage0),
        })
    rows = run.traffic["rows"]
    failed = sum(max(0, rows - len(b["results"])) for b in batches)
    timed = [b for b in batches if not b["traced"]]
    out = {
        "attempted": rows * len(batches), "failed": failed,
        "e2e": {}, "layer": {"slice": slice_rec, "sizes": run.config, "rows": rows, "beam": beam},
        "items": [],
        "notes": {"batches": len(batches), "batch_s": [b["t1"] - b["t0"] for b in batches]},
    }
    if timed:
        out["e2e"]["audio_s_per_s"] = whole_window_rate(
            [b["item"]["content_s"] for b in timed], [(b["t0"], b["t1"]) for b in timed])
        s = run.config
        flops = 0.0
        for b in timed:
            crop = auto_audio_ctx(b["item"]["audio"]) if run.traffic["audio_ctx"] == "auto" else None
            tk = crop or s["max_source_positions"]
            flops += (
                frozen.encoder_flops(s["num_mel_bins"], s["d_model"], s["encoder_layers"],
                                     s["max_source_positions"], rows)
                + frozen.cross_kv_flops(s["d_model"], s["decoder_layers"], tk, rows)
                + frozen.decoder_flops(s["d_model"], s["decoder_layers"], s["vocab_size"], tk,
                                       rows * beam, 4, b["steps"])
            )
        out["layer"]["window"] = {
            "flops": flops, "wall_s": timed[-1]["t1"] - timed[0]["t0"],
            "host_s": [b["host_s"] for b in timed],
        }
    if slice_rec is not None:
        slice_rec = out["layer"]["slice"] = slice_rec.record
        slice_rec["steps"] = batches[0]["steps"]
        slice_rec["encoder_rows"] = rows
    for b in batches:
        audio = b["item"]["audio"]
        crop = auto_audio_ctx(audio) if run.traffic["audio_ctx"] == "auto" else None
        for i, r in enumerate(b["results"][:rows]):
            out["items"].append({"audio": audio[i], "crop": crop, "tokens": r.tokens,
                                 "length": r.length, "score": r.avg_logprob})
    return out


def close(state: dict) -> None:
    state.clear()
