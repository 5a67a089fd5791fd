"""What the span metrics share: the program's spans
(``whisper_tpu_torch.utils.profiling.spans``), read after the window, and
the offline batches they are read over.

A run that traces turns recording on with its first profiler session
(``trace.warm``, after set-up) and it stays on to the end, while the
profiler itself runs only in the slice: the first offline batch, or the
serve window's first seconds. So every batch and request of the window is
recorded, and nothing of set-up or warm-up.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def program_spans(layer: dict) -> Optional[list]:
    """The program's recorded spans in a traced run (None in an untraced
    run, or where the program records none: a version without spans)."""
    if not layer.get("slice"):
        return None
    try:
        from whisper_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans() or None


def offline_batches(spans: list) -> list:
    """The root ``engine.batch`` spans the offline metrics read: those after
    the first (the profiled batch, whose host work the profiler slows),
    which are the batches ``mfu`` and ``engine_host_ms.offline`` read; the
    profiled one where it is the only one recorded."""
    roots = sorted((s for s in spans if s.name == "engine.batch" and s.parent is None),
                   key=lambda s: s.start_ns)
    return roots[1:] or roots


def in_batches(spans: list, batches: list, names) -> Dict[str, List]:
    """The spans named in ``names`` that belong to ``batches`` (by trace id),
    by name."""
    ids = {b.trace_id for b in batches}
    out: Dict[str, List] = {n: [] for n in names}
    for s in spans:
        if s.name in out and s.trace_id in ids:
            out[s.name].append(s)
    return out


def total_ms(spans: list) -> float:
    return sum(s.ms for s in spans)
