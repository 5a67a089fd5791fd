"""A bounded ``torch.profiler`` slice of a run, reduced to what the
per-layer metrics and the ``breakdown`` read.

The reduction reads the profiler's raw event list
(``profile.profiler.kineto_results.events()``) once, without building
the profiler's event tree, so that a slice of a million kernel launches
reduces in seconds. Device activity is every event on a CUDA device:
kernels, copies and fills, on any stream. Its busy time is the union of
their intervals within the slice (streams that overlap count once), and
an idle gap is a stretch of the slice with no device activity. Where the
slice traced the host too, each gap is put down to the innermost host
operation running at its midpoint.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.common.stats import merged

TOP = 10
NAME = 160  # characters of a kernel's name kept in the breakdown


class Slice:
    """``with Slice() as s: ...`` profiles the body's device activity
    (on a machine without a card, the host's operators); ``s.record`` reduces it on
    first use, which may come later, when the run can spare the time. The
    body's device work is synchronised on both ends, so that the slice's
    wall covers it. The profiler is stopped through
    ``torch._C._autograd._disable_profiler``, which hands back the raw
    events without the event tree ``profile.__exit__`` builds. The first
    slice of a process pays the profiler's start-up: a run that traces
    opens an empty one during set-up (:func:`warm`)."""

    def __init__(self):
        self._results = None
        self._record: Optional[dict] = None

    def __enter__(self):
        from torch.autograd import profiler

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        profiler.profile(use_kineto=True, use_cpu=not cuda,
                         use_device="cuda" if cuda else None).__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self._results = torch._C._autograd._disable_profiler()
        return False

    @property
    def record(self) -> dict:
        if self._record is None:
            t = time.perf_counter()
            self._record = reduce(self._results.events(), self._t0, self._t1)
            self._record["reduce_s"] = time.perf_counter() - t
            self._results = None
        return self._record


def warm() -> None:
    """Start and stop the profiler once, outside any window."""
    with Slice():
        pass


def reduce(events, t0_ns: int, t1_ns: int) -> dict:
    """Kernel count, device time by name, busy seconds and idle gaps of the
    events that lie in [t0_ns, t1_ns]."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name: Dict[str, List[float]] = {}
    busy: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    kernels = 0
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == cuda:
            if d <= 0:
                continue
            name = e.name()
            busy.append((max(s, t0_ns), min(s + d, t1_ns)))
            acc = by_name.setdefault(name, [0, 0.0])
            acc[0] += 1
            acc[1] += d / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif d > 0:
            host.append((s, s + d, e.name()))
    spans = merged(iv for iv in busy if iv[1] > iv[0])
    busy_ns = sum(e - s for s, e in spans)
    gaps = []
    prev = t0_ns
    for s, e in spans + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return {
        "wall_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "by_name": {k: (int(v[0]), v[1]) for k, v in by_name.items()},
        "device_ops": [[k[:NAME], v[1]]
                       for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": _label_gaps(gaps, host),
        "host_traced": bool(host),
    }


def _label_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> list:
    """Idle seconds by the innermost host operation running at each gap's
    midpoint ("host not traced" where the slice has no host events, "no
    host op" where none runs then), the ten largest."""
    totals: Dict[str, float] = {}
    if not host:
        totals["host not traced"] = sum(e - s for s, e in gaps) / 1e9
    else:
        host.sort()
        mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
        live: list = []  # (-start, end, name): the latest-starting live op first
        i = 0
        for mid, length in mids:
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(live, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            label = "no host op"
            while live:
                neg_s, end, name = live[0]
                if end >= mid:
                    # The innermost live op; later ones may start inside it.
                    label = name
                    break
                heapq.heappop(live)
            totals[label] = totals.get(label, 0.0) + length / 1e9
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_seconds(record: dict, symbols) -> Tuple[int, float]:
    """Launches and device seconds of the kernels whose names hold any of
    ``symbols``."""
    n, t = 0, 0.0
    for name, (count, secs) in record["by_name"].items():
        if any(sym in name for sym in symbols):
            n += count
            t += secs
    return n, t
