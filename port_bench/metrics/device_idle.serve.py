"""Share of the traced stretch at the serving window's start in which
nothing ran on the card: one minus the union of all device activity over
the stretch's wall."""

LAYER = "device"
UNIT = "%"
MOVES = "latency_p95_s"


def read(layer: dict):
    sl = layer.get("slice")
    return None if not sl else 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
