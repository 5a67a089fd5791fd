"""What both drivers share: the engine's config from a cell's files, the
program's decode-step counters, and the seeded draws. Audio is put on the
int16 grid (``reference.whisper.int16_grid``), as a WAV holds it, so that
the engine's int16 shipping is exact."""

from __future__ import annotations

import numpy as np


def engine_config(config: dict, traffic: dict, **extra):
    """The program's ``EngineConfig`` for a configuration file and a
    traffic file (its budget and crop), plus ``extra`` fields."""
    from whisper_tpu_torch.config import EngineConfig

    fields = dict(config["engine"])
    fields.update(extra)
    return EngineConfig(model=config["program_model"], max_new_tokens=traffic["max_new_tokens"],
                        audio_ctx=traffic["audio_ctx"], **fields)


def decode_steps() -> int:
    """Single-token decode steps the program has run in this process
    (``decode.beam.steps`` + ``decode.greedy.steps``)."""
    from whisper_tpu_torch.decode import beam, greedy

    return beam.steps + greedy.steps


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per use of the run's seed."""
    return np.random.default_rng([abs(int(seed)), stream])
