"""The host's time to enqueue one decode step: the mean duration of the
program's ``decode.step`` spans (decoder step, log-probs, selection, the
cache reorder or K2's pending permutation; the loop's host read of the
device is ``decode.sync``, outside it), over the untraced batches after the
profiled one (``common/spans.offline_batches``)."""

from port_bench.common.spans import in_batches, offline_batches, program_spans, total_ms

LAYER = "decode loop"
UNIT = "ms/step"
MOVES = "audio_s_per_s"


def value(spans: list):
    steps = in_batches(spans, offline_batches(spans), ("decode.step",))["decode.step"]
    return total_ms(steps) / len(steps) if steps else None


def read(layer: dict):
    spans = program_spans(layer)
    return None if spans is None else value(spans)
