"""The share of the decode loop's host time spent waiting for the card:
the sum of ``decode.sync`` (the loop condition's read of the device, which
drains its queue) over the sum of ``decode.step`` and ``decode.sync``, over
the untraced batches after the profiled one. Near 0 the host's enqueue
sets the pace and the card idles; near 100 the card does."""

from port_bench.common.spans import in_batches, offline_batches, program_spans, total_ms

LAYER = "decode loop"
UNIT = "%"
MOVES = "audio_s_per_s"


def value(spans: list):
    got = in_batches(spans, offline_batches(spans), ("decode.step", "decode.sync"))
    sync, busy = total_ms(got["decode.sync"]), total_ms(got["decode.step"] + got["decode.sync"])
    return 100.0 * sync / busy if busy > 0 else None


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
