"""The share of the decode loop's steps replayed as a captured CUDA graph:
the sum of the ``graphed`` attribute over the sum of ``steps`` on the
program's ``decode.loop`` spans, over the untraced batches after the
profiled one. 100 where every step after a loop's first pick replays one
graph; 0 where the loops run eagerly; nothing where the program's spans
carry no ``graphed`` (a version without captured steps)."""

from port_bench.common.spans import in_batches, offline_batches, program_spans

LAYER = "decode loop"
UNIT = "%"
MOVES = "audio_s_per_s"


def value(spans: list):
    loops = in_batches(spans, offline_batches(spans), ("decode.loop",))["decode.loop"]
    if not any("graphed" in s.attrs for s in loops):
        return None
    steps = sum(s.attrs.get("steps", 0) for s in loops)
    graphed = sum(s.attrs.get("graphed", 0) for s in loops)
    return 100.0 * graphed / steps if steps > 0 else None


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
