"""The routed experts' kernels against their bound: the least time the
traced batch's routed work needs (``common/moe_roofline.routed_bound_s``
on the program's routing counts of that batch: experts touched and routed
rows, for the prefill and the steps apart) over the device time of the
kernels whose names begin with ``moe_expert`` in the slice."""

from port_bench.common.moe_roofline import routed_bound_s
from port_bench.common.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "audio_s_per_s"
SYMBOLS = ("moe_expert",)


def read(layer: dict):
    sl = layer.get("slice")
    counts = (layer.get("routing") or {}).get("traced")
    if not sl or not counts:
        return None
    n, secs = kernel_seconds(sl, SYMBOLS)
    if not n or secs <= 0:
        return None
    return 100.0 * routed_bound_s(counts, layer["sizes"]) / secs
