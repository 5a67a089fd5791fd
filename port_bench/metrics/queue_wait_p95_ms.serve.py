"""How long a served request waits before its prefill: the 95th
percentile (nearest rank) of the program's ``serve.queue`` spans, each
from ``submit`` to the request's being taken into a prefill group, over
every request recorded (the window's: warm-up requests come before
recording starts)."""

from port_bench.common.spans import program_spans
from port_bench.common.stats import percentile

LAYER = "serving"
UNIT = "ms"
MOVES = "latency_p95_s"


def value(spans: list):
    waits = [s.ms for s in spans if s.name == "serve.queue"]
    return percentile(waits, 95) if waits else None


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
