"""whisper-tpu-torch: the PyTorch/CUDA port of ``whisper_tpu``.

A second package beside the JAX one, written in PyTorch for an NVIDIA H100.
It keeps the JAX package's module layout and names, imports nothing of it
(nor JAX), and runs its kernels as hand-written CUDA for Hopper. Entry
points run on the card unless the caller asks for the CPU.
"""

from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig, ModelDims
from whisper_tpu_torch.tokenizer.languages import LANGUAGES, lang_code, language_id
from whisper_tpu_torch.tokenizer.vocab import Vocab

__version__ = "0.1.0"

__all__ = [
    "ModelDims",
    "EngineConfig",
    "MODEL_DIMS",
    "Vocab",
    "language_id",
    "lang_code",
    "LANGUAGES",
]


def __getattr__(name):
    # Lazy, so that `import whisper_tpu_torch` does not import torch.
    if name in ("Engine", "Monolith", "EncDec", "create_engine", "EngineType"):
        from whisper_tpu_torch.engine import engine as _engine

        return getattr(_engine, name)
    raise AttributeError(f"module 'whisper_tpu_torch' has no attribute {name!r}")
