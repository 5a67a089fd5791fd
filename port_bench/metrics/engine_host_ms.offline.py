"""Host time per offline batch outside the engine's own stages: the wall
of ``transcribe_batch`` minus what its ``timer`` records as ``model`` (and
``mel``), i.e. the int16 shipping, the crop, the batch bucket and the
detokenising. Mean over the window's untraced batches."""

LAYER = "engine host prep"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(layer: dict):
    host = (layer.get("window") or {}).get("host_s")
    return 1e3 * sum(host) / len(host) if host else None
