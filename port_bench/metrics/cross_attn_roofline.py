"""The decoder's cross-attention reads against their bound: the stored K/V
bytes of the traced batch's cross reads at the card's memory rate (bytes
bound them: a step has 1 to 5 queries a row) over the device time of the
kernels whose names hold the symbol below (the program's
``cross_attend_*`` kernels, ``ops/cross_attend``).

Bytes: each launch reads one layer's whole K and V of the batch once,
2 · encoder_rows · max_source_positions · d_model elements at the stored
K/V's itemsize (1 for a ``float8`` ``kv_cache_dtype`` in the configuration's
``engine``, else 2). The count is honest only because a launch is one
layer's whole read, for the prefill and each step alike, and the 30 s
cells' crop is the full window (``audio_ctx`` auto keeps all 1500
positions there); a cropped cell would read fewer bytes than counted, so
only the 30 s cells list this metric. Where no such kernel ran (a program
that reads the cross K/V with other kernels) it reads nothing."""

from port_bench.common.peaks import H100_SXM
from port_bench.common.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "audio_s_per_s"
SYMBOLS = ("cross_attend",)


def read(layer: dict):
    sl = layer.get("slice")
    if not sl:
        return None
    n, secs = kernel_seconds(sl, SYMBOLS)
    if not n or secs <= 0:
        return None
    s = layer["sizes"]
    itemsize = 1 if "float8" in str((s.get("engine") or {}).get("kv_cache_dtype")) else 2
    n_bytes = n * 2.0 * sl["encoder_rows"] * s["max_source_positions"] * s["d_model"] * itemsize
    return 100.0 * n_bytes / H100_SXM["hbm_bytes_per_s"] / secs
