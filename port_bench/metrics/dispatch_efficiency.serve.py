"""The slot pool's occupied slot-steps over its dispatched slot-steps,
counted from the profiled stretch's end to the window's last arrival (the
program's own counters, as deltas, so that warm-up's steps, the traced
stretch and the drain are left out)."""

LAYER = "serving"
UNIT = "ratio"
MOVES = "latency_p95_s"


def read(layer: dict):
    d = layer.get("dispatched")
    return layer["occupied"] / d if d else None
