"""Tracing, stage timing, and throughput metrics.

Counterpart of ``whisper_tpu/utils/profiling.py``:

* :class:`StageTimer` — named wall-clock stages with aggregation (count,
  total, mean, last) and a context-manager interface;
* :class:`Throughput` — audio-seconds/s, tokens/s, utterances counters;
* :func:`trace` — a ``torch.profiler`` trace of the card (and the host)
  under the context, written for TensorBoard / Perfetto;
* :func:`annotate` — a named region in that trace (and an NVTX range on the
  card);
* ``DEBUG``-gated tensor dumps (:func:`debug_dump`), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

logger = logging.getLogger("whisper_tpu_torch")


# --- DEBUG-gated dumps -------------------------------------------------------
def debug_enabled() -> bool:
    return bool(os.environ.get("DEBUG"))


def debug_dump(name: str, array) -> None:
    """Shape/dtype/sample dump when $DEBUG is set. Takes a numpy array or a
    torch tensor (copied to the host)."""
    if not debug_enabled():
        return
    import numpy as np

    if hasattr(array, "detach"):
        array = array.detach().float().cpu().numpy()
    a = np.asarray(array)
    head = np.array2string(a.reshape(-1)[:8], precision=4, separator=", ")
    logger.info("DEBUG %s: shape=%s dtype=%s head=%s", name, a.shape, a.dtype, head)


# --- Stage timers ------------------------------------------------------------
@dataclasses.dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    last_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class StageTimer:
    """Accumulating named wall-clock stages.

    >>> timer = StageTimer()
    >>> with timer.stage("encode"):
    ...     run_encoder()
    >>> timer.summary()["encode"].mean_s

    The clock is the host's: time device work only where it ends in a
    synchronisation (the engine records what it already measures)."""

    def __init__(self) -> None:
        self._stats: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        s = self._stats.setdefault(name, StageStats())
        s.count += 1
        s.total_s += seconds
        s.last_s = seconds

    def summary(self) -> Dict[str, StageStats]:
        return dict(self._stats)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"count": v.count, "total_ms": v.total_s * 1e3,
                "mean_ms": v.mean_s * 1e3, "last_ms": v.last_s * 1e3}
            for k, v in self._stats.items()
        }

    def reset(self) -> None:
        self._stats.clear()


# --- Throughput counters -----------------------------------------------------
@dataclasses.dataclass
class Throughput:
    """Counters of audio seconds, tokens and utterances over wall seconds:
    audio-seconds/s is the primary metric; tokens/s and the real-time
    factor derive from the same counters."""

    audio_seconds: float = 0.0
    tokens: int = 0
    utterances: int = 0
    wall_s: float = 0.0

    def add(self, audio_seconds: float, tokens: int, utterances: int,
            wall_s: float) -> None:
        self.audio_seconds += audio_seconds
        self.tokens += tokens
        self.utterances += utterances
        self.wall_s += wall_s

    @property
    def audio_seconds_per_s(self) -> float:
        return self.audio_seconds / self.wall_s if self.wall_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def rtf(self) -> float:
        """Real-time factor: processing time per audio second (< 1 is
        faster than real time)."""
        return self.wall_s / self.audio_seconds if self.audio_seconds else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "audio_seconds": self.audio_seconds,
            "tokens": self.tokens,
            "utterances": self.utterances,
            "wall_s": self.wall_s,
            "audio_seconds_per_s": self.audio_seconds_per_s,
            "tokens_per_s": self.tokens_per_s,
            "rtf": self.rtf,
        }


# --- torch.profiler integration ---------------------------------------------
@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (the host, and the card when
    there is one) under the context, written to ``log_dir`` for
    TensorBoard's profiler plugin or Perfetto. No-ops with a warning if the
    profiler cannot start (e.g. another trace is active)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    import torch

    log_dir = log_dir or os.environ.get(
        "WHISPER_TPU_TRACE_DIR", os.path.join(tempfile.gettempdir(), "whisper_tpu_torch_trace")
    )
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.start()
        started = True
    except RuntimeError as e:  # pragma: no cover - profiler capability varies
        logger.warning("profiler trace unavailable: %s", e)
        started = False
    try:
        yield
    finally:
        if started:
            prof.stop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in a :func:`trace` (``record_function``) and, on the
    card, an NVTX range."""
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
