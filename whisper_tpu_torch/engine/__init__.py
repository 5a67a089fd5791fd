from whisper_tpu_torch.engine.engine import (
    EncDec,
    Engine,
    EngineType,
    Monolith,
    TranscriptionResult,
    create_engine,
)

__all__ = [
    "Engine",
    "EngineType",
    "Monolith",
    "EncDec",
    "create_engine",
    "TranscriptionResult",
]
