"""Kernel launches in the traced batch per decode step it ran: the decode
loop's launch count (the encoder's launches, once per batch, spread over
its steps). Steps are the program's ``decode.beam.steps`` and
``decode.greedy.steps``."""

LAYER = "decode loop"
UNIT = "launches/step"
MOVES = "audio_s_per_s"


def read(layer: dict):
    sl = layer.get("slice")
    if not sl or not sl.get("steps"):
        return None
    return sl["kernels"] / sl["steps"]
