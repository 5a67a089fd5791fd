"""The whole step's share of the card's bf16 peak: analytic FLOPs of the
batches completed untraced in the window (encoder, cross-K/V and decoder,
by the frozen formulas of ``common/frozen.py``) over their wall time times
989 TFLOP/s."""

from port_bench.common.peaks import H100_SXM

LAYER = "model step"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(layer: dict):
    w = layer.get("window")
    if not w or w["wall_s"] <= 0:
        return None
    return 100.0 * w["flops"] / w["wall_s"] / H100_SXM["bf16_flops"]
