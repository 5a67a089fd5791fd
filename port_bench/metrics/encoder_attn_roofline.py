"""Encoder self-attention against its bound: the least time its
operations need at the slice's shapes (4 · rows · heads · T² · head_dim
FLOPs per layer at the bf16 peak) over the device time of the kernels that
do it, found by the symbols below (K1, ``flash_fwd``, today), so that the
share reads the same work whatever kernel implements it."""

from port_bench.common.peaks import H100_SXM
from port_bench.common.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "audio_s_per_s"
SYMBOLS = ("flash_fwd",)


def read(layer: dict):
    sl = layer.get("slice")
    if not sl:
        return None
    n, secs = kernel_seconds(sl, SYMBOLS)
    if not n or secs <= 0:
        return None
    s = layer["sizes"]
    t = s["max_source_positions"]
    flops = (4.0 * sl["encoder_rows"] * s["encoder_attention_heads"] * t * t
             * (s["d_model"] // s["encoder_attention_heads"]) * s["encoder_layers"])
    return 100.0 * flops / H100_SXM["bf16_flops"] / secs
