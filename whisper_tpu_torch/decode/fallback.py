"""Temperature-fallback quality gates (openai-whisper transcribe semantics).

The port's own copy of ``whisper_tpu/decode/fallback.py``: decode at
temperature 0, and when the output fails a cheap quality gate —
zlib-compressible repetition or a low average token logprob — retry at the
next temperature of the ladder until one passes (openai-whisper
transcribe.py ``decode_with_fallback``). The ladder itself runs in
``engine.Engine.transcribe_batch``; the sampling in
``decode/greedy.py`` (``argmax(logits + T * gumbel)``).

Host Python over decoded text and scores only: the gates read a handful of
strings per batch, never device data.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

# openai-whisper's defaults (transcribe.py signature).
DEFAULT_TEMPERATURES: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
DEFAULT_COMPRESSION_RATIO_THRESHOLD = 2.4
DEFAULT_LOGPROB_THRESHOLD = -1.0


def compression_ratio(text: str) -> float:
    """UTF-8 bytes / zlib-compressed bytes — openai-whisper utils.py's
    repetition detector. Degenerate loops ("the the the …") compress far
    better than natural speech; > ~2.4 flags a failed decode."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(
    text: str,
    avg_logprob: Optional[float],
    compression_ratio_threshold: Optional[float] = DEFAULT_COMPRESSION_RATIO_THRESHOLD,
    logprob_threshold: Optional[float] = DEFAULT_LOGPROB_THRESHOLD,
) -> bool:
    """openai-whisper transcribe.py's retry predicate: either gate failing
    (when enabled — pass None to disable a gate) marks the decode as failed.
    ``avg_logprob=None`` (score unavailable) skips the logprob gate."""
    if (
        compression_ratio_threshold is not None
        and compression_ratio(text) > compression_ratio_threshold
    ):
        return True
    if (
        logprob_threshold is not None
        and avg_logprob is not None
        and avg_logprob < logprob_threshold
    ):
        return True
    return False


def normalize_schedule(
    temperature: float, fallback: Optional[Sequence[float]]
) -> Tuple[float, ...]:
    """The temperatures a transcription may try, in order. The configured
    ``temperature`` is the first try; ``fallback`` appends the retry ladder
    (entries ≤ the starting temperature, or not above the previous entry,
    are dropped — retries must add entropy, as openai's increasing
    schedule does)."""
    sched = [float(temperature)]
    for t in fallback or ():
        t = float(t)
        if t > sched[0] and (not sched[1:] or t > sched[-1]):
            sched.append(t)
    return tuple(sched)
