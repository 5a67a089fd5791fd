"""Offline batches through an audio language model's engine
(``whisper_tpu_torch.engine.audio_lm.AudioLM``, which ``create_engine``
returns for such a model): whole batches of clips through
``transcribe_batch`` in a closed loop, one after the other.

Traffic keys: ``rows`` per batch; ``clip_seconds`` [lo, hi] (each batch
is the frozen ``make_batch``'s signal at ``hi``, its rows cut to lengths
spread evenly over [lo, hi] in an order drawn from the seed, each clip
passed at its own length); ``max_new_tokens``; ``audio_ctx``; ``pool``
(distinct batches drawn from the seed, used in turn); ``judge_requests``
(rows the reference judges); ``warm`` (default true: one batch of the
window's shapes before it).

The text ids around the audio come from the family's ``prompt_ids``.
A batch is started only while the mean batch time so far says it ends
inside the window. With ``trace`` the first batch is profiled (the slice)
and the rest run untraced, at least one of them, whose times the window's
rates read. Each item carries the program's routing of its positions
(``AudioLM.last_routing``, None where the program keeps none), which
the family's judge holds against the reference's. The program's routing counters
(``whisper_tpu_torch.models.audio_lm.routing``) are read around each
batch: the traced batch's growth and the untraced batches' together.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from port_bench.common import frozen, moe_roofline
from port_bench.common.stats import whole_window_rate
from port_bench.common.trace import Slice
from port_bench.drivers.common import decode_steps, engine_config, rng
from port_bench.reference.whisper import int16_grid


def _pool(traffic: dict, seed: int) -> list:
    rows = traffic["rows"]
    lo, hi = traffic["clip_seconds"]
    lengths = np.linspace(lo, hi, rows)
    out = []
    for i in range(traffic["pool"]):
        r = rng(seed, 100 + i)
        batch = frozen.make_batch(rows, hi, seed=int(r.integers(1 << 62)))
        n = (r.permutation(lengths) * 16_000).astype(int)
        out.append({"clips": [int16_grid(batch[j, : n[j]]) for j in range(rows)],
                    "content_s": float(lengths.sum())})
    return out


def _routing() -> dict:
    from whisper_tpu_torch.models import audio_lm

    return copy.deepcopy(audio_lm.routing)


def _growth(after: dict, before: dict) -> dict:
    out = {}
    for phase, now in after.items():
        was = before.get(phase, {})
        out[phase] = {k: ([a - b for a, b in zip(v, was.get(k, [0] * len(v)))]
                          if isinstance(v, list) else v - was.get(k, 0)) for k, v in now.items()}
    return out


def _add(total: dict, more: dict) -> dict:
    for phase, now in more.items():
        acc = total.setdefault(phase, {k: [0] * len(v) if isinstance(v, list) else 0
                                       for k, v in now.items()})
        for k, v in now.items():
            acc[k] = [a + b for a, b in zip(acc[k], v)] if isinstance(v, list) else acc[k] + v
    return total


def setup(run) -> dict:
    from whisper_tpu_torch.engine import EngineType, create_engine

    pre, suf = run.family.prompt_ids(run.seed, run.config)
    cfg = engine_config(run.config, run.traffic, lm_prefix_tokens=pre, lm_suffix_tokens=suf,
                        **run.engine_overrides)
    engine = create_engine(EngineType.MONOLITH, cfg, params=run.params, device=run.device)
    pool = _pool(run.traffic, run.seed)
    if run.traffic.get("warm", True):
        engine.transcribe_batch(pool[-1]["clips"])  # warm-up: the window's shapes
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"engine": engine, "pool": pool, "prefix": len(pre) + len(suf)}


def measure(run, state: dict, seconds: float, trace: bool) -> dict:
    engine, pool = state["engine"], state["pool"]
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
        steps0, routing0 = decode_steps(), _routing()
        t0 = time.perf_counter()
        if traced:
            with Slice() as sl:
                results = engine.transcribe_batch(item["clips"])
            slice_rec = sl
        else:
            results = engine.transcribe_batch(item["clips"])
        t1 = time.perf_counter()
        batches.append({"t0": t0, "t1": t1, "traced": traced, "item": item, "results": results,
                        "routes": list(getattr(engine, "last_routing", [])),
                        "steps": decode_steps() - steps0,
                        "routing": _growth(_routing(), routing0),
                        "host_s": (t1 - t0) - engine.timer.summary()["model"].last_s})
    rows = run.traffic["rows"]
    failed = sum(max(0, rows - len(b["results"])) for b in batches)
    timed = [b for b in batches if not b["traced"]]
    out = {
        "attempted": rows * len(batches), "failed": failed,
        "e2e": {}, "layer": {"slice": slice_rec, "sizes": run.config, "rows": rows},
        "items": [],
        "notes": {"batches": len(batches), "batch_s": [b["t1"] - b["t0"] for b in batches]},
    }
    untraced: dict = {}
    for b in timed:
        _add(untraced, b["routing"])
    out["layer"]["routing"] = {"untraced": untraced}
    if timed:
        out["e2e"]["audio_s_per_s"] = whole_window_rate(
            [b["item"]["content_s"] for b in timed], [(b["t0"], b["t1"]) for b in timed])
        flops = 0.0
        for b in timed:
            prefix = [state["prefix"] + moe_roofline.positions(len(c), run.config)
                      for c in b["item"]["clips"]]
            r = b["routing"]
            flops += moe_roofline.lm_flops(
                run.config, prefix, b["steps"],
                r.get("prefill", {}).get("rows", 0) + r.get("step", {}).get("rows", 0))
        out["layer"]["window"] = {"flops": flops, "wall_s": timed[-1]["t1"] - timed[0]["t0"],
                                  "host_s": [b["host_s"] for b in timed]}
    out["notes"]["routing_untraced"] = untraced
    if slice_rec is not None:
        slice_rec = out["layer"]["slice"] = slice_rec.record
        slice_rec["steps"] = batches[0]["steps"]
        slice_rec["encoder_rows"] = rows
        out["layer"]["routing"]["traced"] = batches[0]["routing"]
    for b in batches:
        routes = b["routes"] or [None] * rows
        for clip, r, route in zip(b["item"]["clips"], b["results"][:rows], routes):
            out["items"].append({"audio": clip, "tokens": r.tokens, "generated": r.length,
                                 "routing": route,
                                 "length": state["prefix"] + r.length
                                 + moe_roofline.positions(len(clip), run.config)})
    return out


def close(state: dict) -> None:
    state.clear()
