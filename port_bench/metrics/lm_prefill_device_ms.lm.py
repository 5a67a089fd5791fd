"""The card's time for the language model's prefill per batch: the device
time of the program's ``lm.prefill`` spans (two CUDA events on the stream
it is enqueued on), summed per batch and averaged over the untraced
batches after the profiled one. Nothing where the program records no such
span or a span has no device time."""

from port_bench.common.spans import in_batches, offline_batches, program_spans

LAYER = "LM prefill"
UNIT = "ms/batch"
MOVES = "audio_s_per_s"


def value(spans: list):
    batches = offline_batches(spans)
    got = in_batches(spans, batches, ("lm.prefill",))["lm.prefill"]
    if not got or any(s.device_ms is None for s in got):
        return None
    return sum(s.device_ms for s in got) / len(batches)


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
