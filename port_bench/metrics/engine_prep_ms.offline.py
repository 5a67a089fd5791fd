"""The engine's host work per batch, timed inside the program: the sum of
its ``engine.prepare`` (padding, the int16 cast, the batch bucket, the
"auto" crop) and ``engine.results`` (the fallback bookkeeping, the timer
and throughput records, detokenising) spans per batch, averaged over the
untraced batches after the profiled one. The same layer as
``engine_host_ms.offline``, which times it from outside."""

from port_bench.common.spans import in_batches, offline_batches, program_spans, total_ms

LAYER = "engine host prep"
UNIT = "ms/batch"
MOVES = "audio_s_per_s"


def value(spans: list):
    batches = offline_batches(spans)
    got = in_batches(spans, batches, ("engine.prepare", "engine.results"))
    if not batches or not got["engine.prepare"]:
        return None
    return total_ms(got["engine.prepare"] + got["engine.results"]) / len(batches)


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
