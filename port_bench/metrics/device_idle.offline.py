"""Share of the traced batch's wall in which nothing ran on the card: one
minus the union of all device activity (kernels, copies, fills, on every
stream) over the slice's wall."""

LAYER = "device"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(layer: dict):
    sl = layer.get("slice")
    return None if not sl else 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
