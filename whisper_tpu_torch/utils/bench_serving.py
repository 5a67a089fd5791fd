"""Serving-layer throughput of the three front-ends over one arrival sequence.

    python3 -m whisper_tpu_torch.utils.bench_serving [--model dev] [--n 32]
        [--slots 8] [--prefill-batch 4] [--max-new 32] [--dtype float32]
        [--language en] [--encode-device-index N] [--skip-async]
        [--skip-disagg] [--sync-every S] [--eot-bias B] [--arrival-ms MS]
        [--device cuda]

Counterpart of ``tools/bench_serving.py``, with its flags and defaults;
its ``--platform`` is ``--device`` here (``cuda`` by default), and
``--encode-device-index N`` puts the disaggregated prefill on
``cuda:N`` (on one card: the same device, on its own thread). The same
utterances go through, in order:

* ``AsyncTranscriber(max_batch=slots)``: lock-step padded batches;
* ``ContinuousTranscriber``: the slot pool, prefill blocking the decode;
* ``DisaggregatedTranscriber``: the prefill on its own thread feeding the pool.

The engine is ``EngineType.ENCDEC`` with ``audio_ctx=None`` (the tool
compares scheduling, and the slot pool always decodes the full window),
random weights from seed 0; ``--eot-bias`` adds a bias on the synthetic
vocabulary's EOT (``config.logit_bias``), so that decodes stop at random
lengths. The utterances are the tool's: ``default_rng(0)``, a length
drawn by ``integers(16_000, 480_000)``, then ``0.1 · standard_normal``.
Each front-end is warmed and timed on the same instance: its
``warmup()``, one ``transcribe`` of the first utterance, then every
utterance submitted (``--arrival-ms`` apart) and its result awaited in
order on the host clock.

One JSON line per front-end with the tool's keys (``occupancy`` and
``dispatch_efficiency`` for the slot pools) and the device and card (name
and power limit, nvidia-smi), then ``speedup_disagg_vs_continuous``.
:func:`run` is the entry point for scripts and tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.engine.serving import (
    AsyncTranscriber,
    ContinuousTranscriber,
    DisaggregatedTranscriber,
)
from whisper_tpu_torch.ops import attention
from whisper_tpu_torch.tokenizer.vocab import Vocab, num_languages_for
from whisper_tpu_torch.utils.bench import card_line, device_name

FRONTENDS = ("async", "continuous", "disaggregated")
RESULT_TIMEOUT_S = 600.0  # per future, as the tool waits: a hang fails the run


def serving_config(model: str = "dev", language: str = "en", dtype: str = "float32",
                   max_new: int = 32, eot_bias: Optional[float] = None) -> EngineConfig:
    """The tool's config: the full audio window, and ``eot_bias`` (if any)
    on the synthetic vocabulary's EOT."""
    config = EngineConfig(model=model, language=language, dtype=dtype, max_new_tokens=max_new,
                          audio_ctx=None)
    if eot_bias is not None:
        v = Vocab.synthetic(multilingual=config.multilingual,
                            num_languages=num_languages_for(config.dims().n_vocab))
        config = dataclasses.replace(config, logit_bias=((v.specials.eot, eot_bias),))
    return config


def utterances(n: int) -> list:
    """The tool's utterances: seed 0, 1–30 s of ``0.1 · standard_normal``."""
    rng = np.random.default_rng(0)
    return [
        (0.1 * rng.standard_normal(int(rng.integers(16_000, 480_000)))).astype(np.float32)
        for _ in range(n)
    ]


def _flushes(engine) -> int:
    """``transcribe_batch`` calls so far: the engine times each as "model"."""
    stats = engine.timer.summary().get("model")
    return stats.count if stats else 0


def _drive(name: str, make, engine, utts, arrival_ms: float) -> dict:
    """Warm and time one front-end on the same instance (module docstring).
    Returns its printable record, its results in submit order, its prefill
    dispatches (slot pools) or flushes (async) and K1's launches over the
    whole drive, construction and warm-up included."""
    k1_before, flushes_before = attention.launches, _flushes(engine)
    t2 = make()
    with t2:
        t2.warmup()
        t2.transcribe(utts[0])
        t0 = time.perf_counter()
        futures, submit_ts, done_ts = [], [], []
        for u in utts:
            if arrival_ms and futures:
                time.sleep(arrival_ms / 1e3)
            submit_ts.append(time.perf_counter())
            futures.append(t2.submit(u))
        results = []
        for f in futures:
            results.append(f.result(timeout=RESULT_TIMEOUT_S))
            done_ts.append(time.perf_counter())
        dt = time.perf_counter() - t0
    lats = [d - s for s, d in zip(submit_ts, done_ts)]
    lens = [r.length for r in results]
    extra = {}
    if hasattr(t2, "dispatch_efficiency"):
        extra = {"occupancy": t2.occupancy, "dispatch_efficiency": t2.dispatch_efficiency}
        dispatches = t2._prefill_dispatches
    else:
        dispatches = _flushes(engine) - flushes_before
    n = len(utts)
    audio_s = sum(len(u) for u in utts) / 16_000.0
    record = {
        "frontend": name, **extra, "utterances": n, "wall_s": dt, "utterances_per_s": n / dt,
        "audio_s_per_s": audio_s / dt, "latency_mean_s": float(np.mean(lats)),
        "latency_max_s": float(np.max(lats)), "decode_len_mean": float(np.mean(lens)),
        "decode_len_std": float(np.std(lens)), "decode_len_minmax": [int(min(lens)), int(max(lens))],
        "device": device_name(engine.device),
        "card": card_line() if engine.device.type == "cuda" else None,
    }
    return {"record": record, "results": results, "dispatches": dispatches,
            "k1_launches": attention.launches - k1_before}


def run(
    model: str = "dev", n: int = 32, slots: int = 8, prefill_batch: int = 4, max_new: int = 32,
    dtype: str = "float32", language: str = "en", encode_device_index: Optional[int] = None,
    skip_async: bool = False, skip_disagg: bool = False, sync_every: Optional[int] = None,
    eot_bias: Optional[float] = None, arrival_ms: float = 0.0, *, engine=None,
    device: str = "cuda",
) -> dict:
    """The tool's measurement (module docstring). ``engine``: an EncDec
    whose config is :func:`serving_config` of these arguments; None builds
    one from random weights (seed 0) on ``device``, which must exist.
    Returns {front-end: :func:`_drive`'s dict} in the order run, and
    ``speedup_disagg_vs_continuous`` where both slot pools ran."""
    config = serving_config(model, language, dtype, max_new, eot_bias)
    if engine is None:
        engine = create_engine(EngineType.ENCDEC, config, seed=0, device=device)
    elif engine.config != config:
        raise ValueError(f"bench_serving: the engine's config {engine.config} is not the flags' {config}")
    utts = utterances(n)
    kw = {} if sync_every is None else {"sync_every": sync_every}
    enc_dev = None if encode_device_index is None else f"cuda:{encode_device_index}"
    out = {}
    if not skip_async:
        out["async"] = _drive("async", lambda: AsyncTranscriber(engine, max_batch=slots), engine,
                              utts, arrival_ms)
    out["continuous"] = _drive("continuous", lambda: ContinuousTranscriber(
        engine, n_slots=slots, prefill_batch=prefill_batch, **kw), engine, utts, arrival_ms)
    if not skip_disagg:
        out["disaggregated"] = _drive("disaggregated", lambda: DisaggregatedTranscriber(
            engine, n_slots=slots, prefill_batch=prefill_batch, encode_device=enc_dev, **kw),
            engine, utts, arrival_ms)
        out["speedup_disagg_vs_continuous"] = (
            out["continuous"]["record"]["wall_s"] / out["disaggregated"]["record"]["wall_s"]
        )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dev")
    ap.add_argument("--n", type=int, default=32, help="number of utterances")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prefill-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--language", default="en")
    ap.add_argument("--encode-device-index", type=int, default=None,
                    help="run the disaggregated prefill on cuda:N (default: the engine's device)")
    ap.add_argument("--skip-async", action="store_true")
    ap.add_argument("--skip-disagg", action="store_true")
    ap.add_argument("--sync-every", type=int, default=None,
                    help="decode steps per slot-pool dispatch (default: serving.py's)")
    ap.add_argument("--eot-bias", type=float, default=None,
                    help="additive EOT logit bias (config.logit_bias): decodes stop at random lengths")
    ap.add_argument("--arrival-ms", type=float, default=0.0,
                    help="gap between submits (steady arrivals instead of a burst)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_serving: needs a CUDA card (torch.cuda.is_available() is false); "
                 "--device cpu runs on the CPU")
    out = run(args.model, args.n, args.slots, args.prefill_batch, args.max_new, args.dtype,
              args.language, args.encode_device_index, args.skip_async, args.skip_disagg,
              args.sync_every, args.eot_bias, args.arrival_ms, device=args.device)
    for name in FRONTENDS:
        if name in out:
            print(json.dumps(out[name]["record"]), flush=True)
    if "speedup_disagg_vs_continuous" in out:
        print(json.dumps({"speedup_disagg_vs_continuous": out["speedup_disagg_vs_continuous"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
