"""The share of the slot pool's busy time spent waiting for the card: the
sum of the program's ``serve.sync`` spans (the harvest's wait for the
snapshot copy of the previous macro-step) over the sum of
``serve.macro_step``, ``serve.prefill`` and ``serve.harvest`` (which holds
``serve.sync``), over the whole window."""

from port_bench.common.spans import program_spans, total_ms

LAYER = "serving"
UNIT = "%"
MOVES = "latency_p95_s"
BUSY = ("serve.macro_step", "serve.prefill", "serve.harvest")


def value(spans: list):
    busy = total_ms([s for s in spans if s.name in BUSY])
    sync = total_ms([s for s in spans if s.name == "serve.sync"])
    return 100.0 * sync / busy if busy > 0 else None


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
