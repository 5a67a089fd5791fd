"""The card's time for the log-mel and the encoder per batch: the device
time of the program's ``engine.encode`` spans (two CUDA events on the
stream the work is enqueued on), summed per batch and averaged over the
untraced batches after the profiled one. Nothing where a span has no
device time (a run off the card)."""

from port_bench.common.spans import in_batches, offline_batches, program_spans

LAYER = "frontend, encoder"
UNIT = "ms/batch"
MOVES = "audio_s_per_s"


def value(spans: list):
    batches = offline_batches(spans)
    enc = in_batches(spans, batches, ("engine.encode",))["engine.encode"]
    if not enc or any(s.device_ms is None for s in enc):
        return None
    return sum(s.device_ms for s in enc) / len(batches)


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
