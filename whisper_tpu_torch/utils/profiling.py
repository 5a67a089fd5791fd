"""Tracing, stage timing, and throughput metrics.

Counterpart of ``whisper_tpu/utils/profiling.py``:

* :class:`StageTimer` — named wall-clock stages with aggregation (count,
  total, mean, last) and a context-manager interface;
* :class:`Throughput` — audio-seconds/s, tokens/s, utterances counters;
* :func:`trace` — a ``torch.profiler`` trace of the card (and the host)
  under the context, written for TensorBoard / Perfetto;
* :func:`annotate` and :func:`record` — the program's spans (below);
* ``DEBUG``-gated tensor dumps (:func:`debug_dump`), as in the JAX package.

Spans. The program marks its layer boundaries with :func:`annotate`
(``with annotate("decode.step"): ...``). A span is recorded while a torch
profiler session has been started in the process
(``torch.autograd.profiler._is_profiler_enabled``, which every thread
sees): :func:`trace`, ``torch.profiler.profile`` or the autograd profiler
turn recording on, and nothing else does. Off, :func:`annotate` reads that
flag and returns a shared no-op context. On, each span keeps its name, its
start and end on ``time.time_ns()`` (the clock of the profiler's events, so
a span lies over the device trace), its id, the id of the innermost span
open in the same thread (its parent), a trace id (a batch's or a request's
number from :func:`next_number`; a span without one takes its parent's),
its thread and a few integer attributes; where the thread's own profiler
is running it also enters ``record_function``, so that a :func:`trace`
file shows the span on its timeline. A span given a CUDA ``device``
carries the card's time between two CUDA events recorded on the current
stream at its ends, resolved when :func:`spans` is read. Spans are kept in
memory, at most :data:`MAX_SPANS` (later ones are counted in
:func:`dropped_spans`), until :func:`reset_spans`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


# --- Spans -------------------------------------------------------------------
MAX_SPANS = 1 << 20


@dataclasses.dataclass
class Span:
    """One recorded span. ``device_ms`` is the card's time between the
    span's two CUDA events (None where it has none)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    trace_id: Optional[int]
    thread: int
    attrs: Dict[str, int]
    device_ms: Optional[float] = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Recorder:
    """The bounded span buffer of the process: one tuple per span (its
    :class:`Span` fields, then its CUDA events or None), made into
    :class:`Span` objects when read."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.spans: List[tuple] = []
        self.dropped = 0

    def add(self, span: tuple) -> None:
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(span)
            else:
                self.dropped += 1


_recorder = _Recorder()
_ids = itertools.count(1)
_numbers = itertools.count()
_local = threading.local()


def _stack() -> list:
    """The spans and scopes open in this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """The shared context :func:`annotate` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, a, b, c):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Live:
    """An open span; recorded when its ``with`` ends."""

    __slots__ = ("name", "trace_id", "attrs", "device", "id", "parent", "start_ns", "_rf", "_e0")

    def __init__(self, name: str, trace_id: Optional[int], device, attrs: Dict[str, int]):
        self.name, self.trace_id, self.device, self.attrs = name, trace_id, device, attrs
        self._rf = self._e0 = None

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.trace_id is None and top is not None:
            self.trace_id = top.trace_id
        self.id = next(_ids)
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e0.record(torch.cuda.current_stream(self.device))
        self.start_ns = time.time_ns()
        return self

    def set(self, **attrs) -> None:
        """Add integer attributes known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, a, b, c):
        end_ns = time.time_ns()
        events = None
        if self._e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(torch.cuda.current_stream(self.device))
            events = (self._e0, e1)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _stack().pop()
        _recorder.add((self.name, self.start_ns, end_ns, self.id, self.parent, self.trace_id,
                       threading.get_ident(), self.attrs, events))
        return False


class _Scope:
    """Spans opened inside take ``trace_id`` and the parent ``id``."""

    __slots__ = ("trace_id", "id")

    def __init__(self, trace_id: Optional[int], parent: Optional[int]):
        self.trace_id, self.id = trace_id, parent

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, a, b, c):
        _stack().pop()
        return False


def recording() -> bool:
    """Whether spans are being recorded (a profiler session has started)."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str, trace_id: Optional[int] = None, device=None, **attrs: int):
    """A span around the ``with`` body, named ``name`` (a shared no-op
    context while recording is off). ``attrs`` are integers; more can be
    added inside with ``.set(...)``. ``device``: a CUDA device on which
    the span's work is enqueued, to time it on the card too."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Live(name, trace_id, device, attrs)


def scope(trace_id: Optional[int], parent: Optional[int] = None):
    """Spans opened inside the ``with`` (with no open span of their own
    between) take ``trace_id`` and ``parent``: the work of one batch done
    in pieces, whose root span is recorded at its end (:func:`record`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Scope(trace_id, parent)


def record(name: str, start_ns: int, end_ns: int, trace_id: Optional[int] = None,
           span_id: Optional[int] = None, **attrs: int) -> None:
    """Record a span with no parent that started earlier, perhaps in
    another thread (a request's wait in a queue). ``span_id``: one taken
    from :func:`next_span_id` that :func:`scope` gave to its children."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    _recorder.add((name, start_ns, end_ns, next(_ids) if span_id is None else span_id,
                   None, trace_id, threading.get_ident(), attrs, None))


def next_number() -> int:
    """A new trace id: the number of a batch or a request."""
    return next(_numbers)


def next_span_id() -> int:
    """A span id for a span recorded later by :func:`record`."""
    return next(_ids)


def spans() -> List[Span]:
    """The spans recorded so far, oldest first, with their device times
    (this waits for the card to reach each timed span's end)."""
    with _recorder.lock:
        raw = list(_recorder.spans)
    out = []
    for *fields, events in raw:
        device_ms = None
        if events is not None:
            events[1].synchronize()
            device_ms = events[0].elapsed_time(events[1])
        out.append(Span(*fields, device_ms=device_ms))
    return out


def dropped_spans() -> int:
    """Spans not kept because the buffer held :data:`MAX_SPANS`."""
    return _recorder.dropped


def reset_spans() -> None:
    """Forget every recorded span and the dropped count."""
    with _recorder.lock:
        _recorder.spans.clear()
        _recorder.dropped = 0
