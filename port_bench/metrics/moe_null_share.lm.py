"""The share of the gate's picks that went to a null expert (a slot that
computes nothing), over the prefill and the steps of the untraced batches:
the program's routing counters (``whisper_tpu_torch.models.audio_lm.routing``),
read around each batch."""

LAYER = "routed experts"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(layer: dict):
    counts = (layer.get("routing") or {}).get("untraced")
    if not counts:
        return None
    picks = sum(sum(p["picks"]) for p in counts.values())
    null = sum(p["null_picks"] for p in counts.values())
    return 100.0 * null / picks if picks else None
