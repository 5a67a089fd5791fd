#!/usr/bin/env python3
"""Readings that the limits and the serve cell's rate are set from. Not
run by the benchmark's own runs.

    python3 port_bench/calibrate.py readings <cell> --seeds 1,2,3 [--seconds 1] [--control]
        [--engine kv_cache_dtype=float8_e4m3fn]
    python3 port_bench/calibrate.py sweep <cell> --seed 1 --rates 4,8,12 [--seconds 20]

``readings``: for each seed, in one process, draw the weights, build the
cell's program, run a short window at the cell's own sizes and load (an
offline cell: one batch, with no warm-up before it), and judge what it
served, as a run does, through the functions of the configuration's model
family (``families/<family>.py``: ``make_params``, ``judge``);
``--control`` judges it also against the cell's control (the family's
reference a precision below; for Whisper ``reference.control`` in the
configuration), reading the control's numbers on the same prompts and
tokens; ``--engine`` runs the program with a field of its config changed
(a lower-precision path of the program's own). One JSON line per seed.

``sweep``: one serve cell's program (its weights from the family's
``make_params``), then a window at each offered rate,
printing the latency percentiles, the requests that finished and the
slot pool's dispatch efficiency at each.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run as R  # noqa: E402


def _value(text: str):
    try:
        return json.loads(text)
    except ValueError:
        return text


def readings(args) -> None:
    import torch

    from port_bench.common.precision import strict_f32

    engine = dict(kv.split("=", 1) for kv in args.engine)
    engine = {k: _value(v) for k, v in engine.items()}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = R.prepare(args.cell, seed, "cuda", {"traffic": {"warm": False}, "engine": engine})
        driver = R.load_module(R.BENCH / "drivers" / f"{run.traffic['driver']}.py")
        run.params = run.family.make_params(run.config, seed, run.device)
        t0 = time.perf_counter()
        state = driver.setup(run)
        out = driver.measure(run, state, args.seconds, False)
        t1 = time.perf_counter()
        driver.close(state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        strict_f32()
        nums = run.family.judge(run, R.sample(out["items"], run.traffic["judge_requests"], seed),
                                control=args.control)
        print(json.dumps({"cell": args.cell, "seed": seed, "engine": engine,
                          "window_s": t1 - t0, "judge_s": time.perf_counter() - t1,
                          "failed": out["failed"], **nums, "notes": out["notes"]}), flush=True)
        run.params = None


def sweep(args) -> None:
    import torch

    run = R.prepare(args.cell, args.seed, "cuda")
    driver = R.load_module(R.BENCH / "drivers" / f"{run.traffic['driver']}.py")
    run.params = run.family.make_params(run.config, args.seed, run.device)
    state = driver.setup(run)
    for rate in [float(r) for r in args.rates.split(",")]:
        run.traffic["rate_per_s"] = rate
        out = driver.measure(run, state, args.seconds, False)
        lay = out["layer"]
        print(json.dumps({"rate_per_s": rate, "attempted": out["attempted"], "failed": out["failed"],
                          **out["e2e"], "dispatch_efficiency": lay["occupied"] / max(1, lay["dispatched"]),
                          **out["notes"]}), flush=True)
        torch.cuda.synchronize()
    driver.close(state)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("cell")
    r.add_argument("--seeds", required=True)
    r.add_argument("--seconds", type=float, default=1.0)
    r.add_argument("--control", action="store_true")
    r.add_argument("--engine", action="append", default=[])
    s = sub.add_parser("sweep")
    s.add_argument("cell")
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--rates", required=True)
    s.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    (readings if args.what == "readings" else sweep)(args)


if __name__ == "__main__":
    main()
