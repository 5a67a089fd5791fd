"""Served transcription: requests arrive on a schedule, whatever the
program's pace (an open loop), into the slot pool
(``ContinuousTranscriber``) over an ``EncDec`` engine, as
``TranscribeServer`` runs it by default.

Traffic keys: ``n_slots``, ``prefill_batch``, ``sync_every`` (the pool);
``rate_per_s`` (mean arrivals per second); ``max_new_tokens``; ``audio_ctx``; ``warm_requests``
(served before the window, their own utterances); ``drain_timeout_s``
(how long after the window's end a request may still finish);
``trace_seconds`` (the profiled stretch at the window's start; its
events are reduced after the drain);
``judge_requests``.

The gaps between arrivals are the quantiles of an exponential
distribution at ``rate_per_s``, one per request of the window, in one
fixed order: every seed offers the same arrivals. (An order drawn from
the seed moved the median latency by up to 20% from seed to seed on an
H100, where two runs of one seed agreed to 1%.) The seed draws the
weights and the utterances, from the frozen ``utterances`` generator
(1–30 s, each padded to the 30 s window by the pool): which audio
arrives when.
Each request is timed from when it was due, not from when it was
submitted, to its result on the host; a request that fails, or has not
finished ``drain_timeout_s`` after the window, counts as infinitely late
and as failed.
"""

from __future__ import annotations

import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from port_bench.common import frozen
from port_bench.common.stats import percentile
from port_bench.common.trace import Slice
from port_bench.drivers.common import engine_config, rng
from port_bench.reference.whisper import int16_grid


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): ``round(rate · seconds)`` exponential
    quantile gaps, in one fixed shuffled order whatever the seed, scaled
    to fill the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = rng(0, 300).permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


def setup(run) -> dict:
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.engine.serving import ContinuousTranscriber

    t = run.traffic
    cfg = engine_config(run.config, t, **run.engine_overrides)
    engine = create_engine(EngineType.ENCDEC, cfg, params=run.params, device=run.device)
    pool = ContinuousTranscriber(engine, n_slots=t["n_slots"], prefill_batch=t["prefill_batch"],
                                 sync_every=t["sync_every"])
    pool.warmup()
    warm = [int16_grid(u) for u in frozen.utterances(t["warm_requests"], seed=int(
        rng(run.seed, 301).integers(1 << 62)))]
    for f in [pool.submit(u) for u in warm]:
        f.result(timeout=600)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"engine": engine, "pool": pool}


def measure(run, state: dict, seconds: float, trace: bool) -> dict:
    t = run.traffic
    pool = state["pool"]
    due = arrivals(t["rate_per_s"], seconds)
    utts = [int16_grid(u) for u in frozen.utterances(len(due), seed=int(
        rng(run.seed, 302).integers(1 << 62)))]
    done_at, due_at = [None] * len(due), [None] * len(due)

    def stamp(i):
        def cb(_fut):
            done_at[i] = time.perf_counter()
        return cb

    occ0, disp0 = pool._occupied_slot_steps, pool._dispatched_slot_steps
    futures, lag = [], []
    # The profiler starts while the pool is idle and stops after the
    # window's first stretch: turning it on under the pool's worker thread
    # crashed one run in three. Stopping it holds the host for seconds, so
    # the arrivals after it are due that much later (the load stays the
    # cell's, with no burst of the overdue), and the pool's counters are
    # read from then on to the last arrival.
    sl = Slice().__enter__() if trace else None
    traced = None
    t0 = time.perf_counter() + 0.05
    for i, d in enumerate(due):
        if sl is not None and d >= t["trace_seconds"]:
            t_stop = time.perf_counter()
            sl.__exit__(None, None, None)
            traced, sl = sl, None
            t0 += time.perf_counter() - t_stop
            occ0, disp0 = pool._occupied_slot_steps, pool._dispatched_slot_steps
        wait = t0 + d - time.perf_counter()
        if wait > 0:  # one wake per arrival, so the pool's worker keeps the GIL between them
            time.sleep(wait)
        f = pool.submit(utts[i])
        due_at[i] = t0 + d
        lag.append(time.perf_counter() - due_at[i])
        f.add_done_callback(stamp(i))
        futures.append(f)
    if sl is not None:  # a window shorter than the stretch
        sl.__exit__(None, None, None)
        traced = sl
    t_end = time.perf_counter()
    occupied, dispatched = pool._occupied_slot_steps - occ0, pool._dispatched_slot_steps - disp0
    results, failed = [], 0
    for f in futures:
        try:
            results.append(f.result(timeout=max(0.0, t_end + t["drain_timeout_s"] - time.perf_counter())))
        except FutureTimeout:
            results.append(None)
            failed += 1
            run.log("a request did not finish by the drain timeout")
        except Exception as e:  # noqa: BLE001 — a failed request is counted, not raised
            results.append(None)
            failed += 1
            run.log(f"a request failed: {e!r}")
    lat = [float("inf") if r is None or done_at[i] is None else done_at[i] - due_at[i]
           for i, r in enumerate(results)]
    lengths = [r.length - 4 for r in results if r is not None]
    out = {
        "attempted": len(due), "failed": failed,
        "e2e": {"latency_p50_s": percentile(lat, 50), "latency_p95_s": percentile(lat, 95)},
        "layer": {
            "slice": traced.record if traced is not None else None,
            "occupied": occupied,
            "dispatched": dispatched,
        },
        "items": [{"audio": utts[i], "crop": None, "tokens": r.tokens, "length": r.length}
                  for i, r in enumerate(results) if r is not None],
        "notes": {"requests": len(due), "generator_lag_max_s": max(lag),
                  "decode_len_median": float(np.median(lengths)) if lengths else None,
                  "decode_len_max": max(lengths, default=None)},
    }
    return out


def close(state: dict) -> None:
    pool = state.pop("pool", None)
    if pool is not None:
        pool.close()
    state.clear()
