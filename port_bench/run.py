#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration is ``port_bench/configs/<config>.json``
(which names its model family, ``port_bench/families/<family>.py``, by a
top-level ``"family"`` key, ``"whisper"`` where it has none), its traffic
mix ``port_bench/traffic/<traffic>.json`` (which names its driver,
``port_bench/drivers/<driver>.py``), its correctness limits
``port_bench/workloads/<cell>.json`` and each per-layer metric
``port_bench/metrics/<metric>.py``. Adding a cell, a mix, a metric or a
model family adds files and entries; no file here changes.

A family file defines ``check(config)`` (the file's sizes agree with the
program's model table; ``AssertionError`` otherwise), ``make_params(config,
seed, device)`` (the weights, drawn from the seed on the device) and
``judge(run, items, control=False)`` (the family's plain reference built
from ``run.params`` and ``run.config``, the sampled ``items`` judged by it:
the numbers the cell's limits name, and with ``control`` also
``control.<name>``, the control's).

A run draws the weights on the card from ``--seed`` with its family's
``make_params``, builds the program (``whisper_tpu_torch``) through its
public entry points, warms up the window's shapes (all of which is
``setup_s``), measures for ``--seconds``, frees the program, judges a
seeded sample of what it served with its family's ``judge``, and prints
one JSON line as the last line of standard output; the numbers compared,
each beside its limit, close both that line (``checks``) and standard
error. With
``--trace 1`` a bounded slice at the window's start is profiled and the
line carries the cell's per-layer metrics instead of its end-to-end ones.

It refuses to run (exit 2, no result) without a CUDA card or with fewer
cards than the cell asks for, and prints no result (exit 3) if JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")
FAMILY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")  # a module's name: no dot, no slash

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location("port_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(config: dict):
    """The module of the configuration's model family,
    ``families/<family>.py``; a name that is not a module's, or that has no
    file, stops the run with one line."""
    family = config.get("family", "whisper")
    path = BENCH / "families" / f"{family}.py"
    if not (isinstance(family, str) and FAMILY.match(family) and path.is_file()):
        raise SystemExit(f"run.py: no model family {family!r} (port_bench/families/<family>.py)")
    return load_module(path)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in reported if "moves" in entry else True


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object
    end_to_end: list
    per_layer: list
    chips: int
    family: object = None
    engine_overrides: dict = dataclasses.field(default_factory=dict)
    params: Optional[dict] = None
    log: Callable = print


def prepare(cell: str, seed: int, device, overrides: Optional[dict] = None) -> Run:
    """The cell's files, by name, with ``overrides`` ({"config": {...},
    "traffic": {...}, "engine": {...}}) merged in (tests use them)."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if spec is None:
        raise SystemExit(f"run.py: no cell {cell!r} in BENCHMARK.json")
    overrides = overrides or {}
    config = {**load_json(BENCH / "configs" / f"{spec['config']}.json"), **overrides.get("config", {})}
    traffic = {**load_json(BENCH / "traffic" / f"{spec['traffic']}.json"), **overrides.get("traffic", {})}
    limits = load_json(BENCH / "workloads" / f"{cell}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, {"setup_s"})]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, cell, reported)]
    return Run(cell=cell, config=config, traffic=traffic, limits=limits, seed=int(seed),
               device=torch.device(device), end_to_end=e2e, per_layer=layer,
               chips=int(spec["chips"]), family=family_module(config),
               engine_overrides=overrides.get("engine", {}),
               log=lambda msg: print(f"[port_bench] {msg}", file=sys.stderr, flush=True))


def sample(items: list, n: int, seed: int) -> list:
    """``n`` served requests drawn from the seed, the longest among them."""
    from port_bench.drivers.common import rng

    if len(items) <= n:
        return list(items)
    longest = max(range(len(items)), key=lambda i: items[i]["length"])
    rest = [i for i in range(len(items)) if i != longest]
    pick = rng(seed, 400).choice(rest, size=n - 1, replace=False)
    return [items[longest]] + [items[int(i)] for i in sorted(pick)]


def execute(run: Run, seconds: float, trace: bool, t_start: float = T_START) -> dict:
    """Set up, measure, free, judge; the result line as a dict."""
    import torch

    from port_bench.common import trace as trace_mod
    from port_bench.common.precision import strict_f32

    driver = load_module(BENCH / "drivers" / f"{run.traffic['driver']}.py")
    cuda = run.device.type == "cuda"
    run.params = run.family.make_params(run.config, run.seed, run.device)
    state = driver.setup(run)
    if trace:
        trace_mod.warm()
    gc.collect()
    gc.freeze()  # what set-up made stays out of the window's collections
    setup_s = time.perf_counter() - t_start
    run.log(f"set-up {setup_s:.3f} s")
    out = driver.measure(run, state, seconds, trace)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    driver.close(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    run.log(f"window done: {json.dumps(out['notes'])}")

    strict_f32()
    t = time.perf_counter()
    numbers = run.family.judge(run, sample(out["items"], run.traffic["judge_requests"], run.seed))
    run.log(f"reference {time.perf_counter() - t:.3f} s: {json.dumps(numbers)}")

    checks = {"failed": {"value": out["failed"], "limit": 0}}
    for name, limit in run.limits.items():
        checks[name] = {"value": numbers.get(name, float("inf")), "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": {}, "device": device}
    if trace:
        sl = out["layer"].get("slice")
        if not sl:
            raise RuntimeError("the traced run profiled no slice")
        device["busy_s"] = sl["busy_s"]
        device["window_s"] = sl["wall_s"]
        for m in run.per_layer:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(out["layer"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
        out["notes"]["trace_reduce_s"] = sl["reduce_s"]
        out["notes"]["slice_kernels"] = sl["kernels"]
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in run.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result["notes"] = out["notes"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")  # no library of the port may load JAX
    # One process with few threads: the host's launch loop is what most
    # cells time, and the CPU thread pool's workers only compete with it.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("run.py: torch.cuda.is_available() is false: this benchmark runs on a CUDA card",
              file=sys.stderr)
        return 2
    run = prepare(args.workload, args.seed, "cuda")
    if torch.cuda.device_count() < run.chips:
        print(f"run.py: the cell asks for {run.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(run, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
