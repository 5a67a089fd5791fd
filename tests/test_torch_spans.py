"""The program's spans (``whisper_tpu_torch/utils/profiling.py``): off they
record nothing; on (once a torch profiler session has started in the
process) they nest by thread, carry trace ids, lie on the profiler's clock
and mark the engine's, the decode loops' and the slot pool's boundaries;
``collectives.stage`` keeps its counts; the buffer is bounded; and the
benchmark's six span metrics read hand-made and recorded span lists."""

import contextlib
import importlib.util
import itertools
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EncDec, Monolith
from whisper_tpu_torch.engine.engine import decode_steps
from whisper_tpu_torch.engine.serving import ContinuousTranscriber
from whisper_tpu_torch.parallel import collectives
from whisper_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

METRICS = Path(__file__).resolve().parents[1] / "port_bench" / "metrics"
TIMEOUT = 120


def _start() -> None:
    """Start a profiler session (host operators only: there is no card)."""
    autograd_profiler.profile(use_kineto=True, use_cpu=True).__enter__()


def _stop():
    """Stop it as the benchmark's ``Slice`` does, through
    ``_disable_profiler``: its events come back and the flag stays set."""
    return torch._C._autograd._disable_profiler()


@contextlib.contextmanager
def _recorded():
    """Recording on, the profiler itself stopped (a benchmark window after
    its traced slice)."""
    _start()
    _stop()
    yield


@pytest.fixture(autouse=True)
def _clean():
    prof.reset_spans()
    yield
    if torch._C._autograd._profiler_enabled():
        _stop()
    autograd_profiler._set_is_profiler_enabled(False)
    prof.reset_spans()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not prof.recording()
    a = prof.annotate("decode.step")
    b = prof.annotate("engine.encode", trace_id=3, device=torch.device("cpu"), rows=4)
    assert a is b and prof.scope(1, 2) is a
    with a as span:
        span.set(steps=1)
        torch.ones(2).add(1)
    prof.record("serve.queue", 1, 2, trace_id=5)
    assert prof.spans() == [] and prof.dropped_spans() == 0


def test_on_nesting_parents_trace_ids_and_attributes():
    with _recorded():
        with prof.annotate("root", trace_id=7, rows=2) as root:
            with prof.annotate("child") as child:
                with prof.annotate("grandchild", trace_id=9):
                    pass
            root.set(steps=5)
        with prof.annotate("alone"):
            pass
        with prof.scope(11, 1234), prof.annotate("scoped"):
            pass
    got = {s.name: s for s in prof.spans()}
    assert list(got) == ["grandchild", "child", "root", "alone", "scoped"]
    r, c, g = got["root"], got["child"], got["grandchild"]
    assert r.parent is None and c.parent == r.id and g.parent == c.id
    assert (r.trace_id, c.trace_id, g.trace_id) == (7, 7, 9)
    assert r.attrs == {"rows": 2, "steps": 5} and c.attrs == {}
    assert r.start_ns <= c.start_ns <= g.start_ns <= g.end_ns <= c.end_ns <= r.end_ns
    assert got["alone"].parent is None and got["alone"].trace_id is None
    assert (got["scoped"].parent, got["scoped"].trace_id) == (1234, 11)
    assert len({s.id for s in got.values()}) == 5
    assert all(s.device_ms is None and s.thread == threading.get_ident() for s in got.values())


def test_on_records_a_thread_started_before_the_profiler():
    go, done, seen = threading.Event(), threading.Event(), []

    def worker():
        go.wait(TIMEOUT)
        seen.append(torch._C._autograd._profiler_enabled())
        with prof.annotate("worker.outer", trace_id=3):
            with prof.annotate("worker.inner"):
                pass
        prof.record("across", 10, 20, trace_id=4, n=1)
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    _start()  # running while the worker records
    with prof.annotate("main"):
        go.set()
        assert done.wait(TIMEOUT)
    _stop()
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert seen == [False]  # the thread's own profiler flag stays off
    got = {s.name: s for s in prof.spans()}
    assert got["worker.inner"].parent == got["worker.outer"].id
    assert got["worker.outer"].parent is None and got["worker.inner"].trace_id == 3
    assert got["worker.outer"].thread == got["worker.inner"].thread != got["main"].thread
    assert (got["across"].start_ns, got["across"].end_ns, got["across"].trace_id,
            got["across"].attrs) == (10, 20, 4, {"n": 1})


def test_clock_is_the_profilers():
    """A session opened and stopped as the benchmark's Slice does: the
    ``aten::add`` inside a span lies within the span's [start_ns, end_ns],
    and the span is on the profiler's timeline (record_function)."""
    x = torch.ones(64)
    _start()
    with prof.annotate("outer"):
        x.add(1)
    events = list(_stop().events())
    (span,) = prof.spans()
    adds = [e for e in events if e.name() == "aten::add"]
    assert len(adds) == 1
    assert span.start_ns <= adds[0].start_ns()
    assert adds[0].start_ns() + adds[0].duration_ns() <= span.end_ns
    assert any(e.name() == "outer" for e in events)
    assert prof.recording()  # stopped this way, the flag stays set


def test_buffer_stops_at_its_bound_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 5)
    with _recorded():
        for i in range(6):
            with prof.annotate("s", i=i):
                pass
        prof.record("r", 0, 1)
        prof.record("r", 0, 1)
    assert [s.attrs["i"] for s in prof.spans()] == [0, 1, 2, 3, 4]
    assert prof.dropped_spans() == 3
    prof.reset_spans()
    assert prof.spans() == [] and prof.dropped_spans() == 0


def _stages():
    """Collectives counted by hand under nested stages and a decorated one."""
    collectives.reset()

    @collectives.stage("align")
    def aligned():
        collectives._count(time.perf_counter())

    with collectives.stage("detect"):
        collectives._count(time.perf_counter())
        with collectives.stage("prefill"):
            collectives._count(time.perf_counter())
    with collectives.stage("step"):
        collectives._count(time.perf_counter())
    aligned()
    out = dict(collectives.by_stage), collectives.calls
    collectives.reset()
    return out


def test_collectives_by_stage_unchanged_under_recording():
    off = _stages()
    with _recorded():
        on = _stages()
    assert on == off == ({"detect": 2, "step": 1, "align": 1}, 4)
    got = prof.spans()
    assert [s.name for s in got] == ["prefill", "detect", "step", "align"]
    assert got[0].parent == got[1].id and got[1].parent is None


def _engine(cls, beam):
    cfg = EngineConfig(model="dev", language="en", dtype="float32", max_new_tokens=4,
                       beam_size=beam)
    return cls.from_random(cfg, seed=0, device="cpu")


def _batches(n, rows=2, seconds=2):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        x = np.zeros((rows + i % 2, 16_000 * seconds), np.float32)
        x[:, :4000] = rng.standard_normal((rows + i % 2, 4000)).astype(np.float32) * 0.1
        out.append(x)
    return out


def _check_batch_spans(spans, roots, steps):
    """Per root: its steps attribute, one decode.step span per step, a
    decode.sync per loop test (one more for the final read), children
    under their parents."""
    assert sum(r.attrs["steps"] for r in roots) == steps
    for r in roots:
        mine = [s for s in spans if s.trace_id == r.trace_id and s is not r]
        n_step = len(_named(mine, "decode.step"))
        n_sync = len(_named(mine, "decode.sync"))
        assert n_step == r.attrs["steps"] and n_sync in (n_step, n_step + 1)
        (loop,) = _named(mine, "decode.loop")
        assert loop.attrs["steps"] == n_step
        assert all(s.parent == loop.id for s in _named(mine, "decode.step"))
        for name in ("engine.prepare", "engine.encode", "decode.prompts", "decode.loop",
                     "engine.results"):
            assert _named(mine, name), name
        for s in _named(mine, "engine.encode"):
            assert s.device_ms is None and s.attrs["rows"] >= r.attrs["rows"]
        assert r.start_ns <= min(s.start_ns for s in mine)
        assert max(s.end_ns for s in mine) <= r.end_ns


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam"])
@pytest.mark.parametrize("cls", [Monolith, EncDec])
def test_engine_batches(cls, beam):
    eng = _engine(cls, beam)
    batches = _batches(2)
    with _recorded():
        steps0 = decode_steps()
        for x in batches:
            eng.transcribe_batch(x)
        steps = decode_steps() - steps0
    spans = prof.spans()
    roots = _named(spans, "engine.batch")
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert len({r.trace_id for r in roots}) == 2
    assert [r.attrs["rows"] for r in roots] == [x.shape[0] for x in batches]
    assert all(r.attrs["padded_rows"] >= r.attrs["rows"] for r in roots)
    assert all(r.attrs["encoder_rows"] == r.attrs["padded_rows"] for r in roots)
    _check_batch_spans(spans, roots, steps)
    assert len(_named(spans, "engine.fetch")) == 2
    if beam == 1:  # each decode step is the "step" stage of collectives
        assert len(_named(spans, "step")) == steps


def test_transcribe_batches_one_root_per_batch():
    eng = _engine(Monolith, 1)
    batches = _batches(3)
    with _recorded():
        steps0 = decode_steps()
        eng.transcribe_batches(batches)
        steps = decode_steps() - steps0
    spans = prof.spans()
    roots = _named(spans, "engine.batch")
    assert len(roots) == 3 and all(r.parent is None for r in roots)
    assert len({r.id for r in roots}) == len({r.trace_id for r in roots}) == 3
    _check_batch_spans(spans, roots, steps)
    for r in roots:
        (prep,) = [s for s in _named(spans, "engine.prepare") if s.trace_id == r.trace_id]
        assert prep.parent == r.id


def test_continuous_requests_each_have_one_queue_and_one_slot_span():
    eng = _engine(EncDec, 1)
    rng = np.random.default_rng(2)
    utts = [rng.standard_normal(16_000 * (1 + i % 3)).astype(np.float32) * 0.1
            for i in range(5)]
    pool = ContinuousTranscriber(eng, n_slots=2, prefill_batch=2)
    try:
        pool.warmup()
        with _recorded():  # the pool's worker was started before
            futures = [pool.submit(u) for u in utts]
            results = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        pool.close()
    assert len(results) == 5
    spans = prof.spans()
    queued = _named(spans, "serve.queue")
    slots = _named(spans, "serve.slot")
    numbers = sorted(s.trace_id for s in queued)
    assert len(set(numbers)) == 5 and sorted(s.trace_id for s in slots) == numbers
    for q in queued:
        (slot,) = [s for s in slots if s.trace_id == q.trace_id]
        assert q.end_ns <= slot.start_ns <= slot.end_ns
    prefills = _named(spans, "serve.prefill")
    assert sum(p.attrs["group"] for p in prefills) == 5
    assert {p.attrs["first"] for p in prefills} <= set(numbers)
    steps = _named(spans, "serve.macro_step")
    assert steps and all(0 < s.attrs["occupied"] <= s.attrs["bucket"] <= 2 for s in steps)
    assert sum(s.attrs["done"] for s in _named(spans, "serve.harvest")) == 5
    assert _named(spans, "serve.sync") == []  # the CPU snapshot needs no wait
    assert (pool.occupied_slot_steps, pool.dispatched_slot_steps, pool.step_dispatches,
            pool.prefill_dispatches) == (pool._occupied_slot_steps, pool._dispatched_slot_steps,
                                         pool._step_dispatches, pool._prefill_dispatches)
    assert pool.prefill_dispatches == len(prefills) and pool._inserted == {}


# --- the benchmark's span metrics ------------------------------------------
def _metric(name):
    spec = importlib.util.spec_from_file_location("span_metric_" + name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ids = itertools.count(1)


def _span(name, start_ms, end_ms, trace_id=None, parent=None, device_ms=None):
    return prof.Span(name, int(start_ms * 1e6), int(end_ms * 1e6), next(_ids), parent, trace_id,
                     1, {}, device_ms=device_ms)


def _offline_spans(device=True):
    """Three batches: the first (profiled) slow, the next two alike."""
    out = []
    for n, t0, scale in ((0, 0, 10.0), (1, 1000, 1.0), (2, 2000, 1.0)):
        root = _span("engine.batch", t0, t0 + 900, trace_id=n)
        out += [
            root,
            _span("engine.prepare", t0, t0 + 2 * scale, n, root.id),
            _span("engine.encode", t0 + 10, t0 + 11, n, root.id,
                  device_ms=40.0 * scale if device else None),
            _span("engine.results", t0 + 800, t0 + 800 + 3 * scale, n, root.id),
            _span("engine.results", t0 + 850, t0 + 850 + 1 * scale, n, root.id),
        ]
        for k in range(4):  # steps of 8 ms, syncs of 2 ms
            out += [_span("decode.sync", t0 + 100 + 10 * k, t0 + 102 + 10 * k, n),
                    _span("decode.step", t0 + 102 + 10 * k, t0 + 110 + 10 * k, n)]
        out.append(_span("decode.sync", t0 + 140, t0 + 140 + 2 * scale, n))
    return out


@pytest.mark.parametrize("name, expected", [
    ("decode_enqueue_ms.offline", 8.0),
    ("decode_sync_share.offline", 100.0 * 10 / (32 + 10)),
    ("encoder_device_ms.offline", 40.0),
    ("engine_prep_ms.offline", 6.0),
])
def test_offline_metrics_on_made_spans(name, expected):
    m = _metric(name)
    assert m.value(_offline_spans()) == pytest.approx(expected)
    only_first = [s for s in _offline_spans() if s.trace_id == 0]
    assert m.value(only_first) is not None  # the profiled batch alone is read
    assert m.value([]) is None and m.read({}) is None


def test_encoder_device_ms_needs_device_times():
    assert _metric("encoder_device_ms.offline").value(_offline_spans(device=False)) is None


def _serve_spans():
    out = [_span("serve.queue", i, i + w) for i, w in enumerate([1.0, 5.0, 2.0] + [3.0] * 17)]
    out += [_span("serve.macro_step", 0, 6), _span("serve.prefill", 6, 10),
            _span("serve.harvest", 10, 15), _span("serve.sync", 11, 13)]
    return out


@pytest.mark.parametrize("name, expected", [
    ("queue_wait_p95_ms.serve", 3.0),  # rank 19 of 20 by nearest rank
    ("worker_sync_share.serve", 100.0 * 2 / 15),
])
def test_serve_metrics_on_made_spans(name, expected):
    m = _metric(name)
    assert m.value(_serve_spans()) == pytest.approx(expected)
    assert m.value([]) is None and m.read({}) is None
    assert m.read({"slice": {"busy_s": 1.0}}) is None  # nothing recorded: nothing read


def test_offline_metrics_on_recorded_spans():
    """A recorded engine run read as a traced benchmark run reads it (the
    metrics' ``read``); a run off the card has no device times."""
    eng = _engine(Monolith, 1)
    with _recorded():
        for x in _batches(3):
            eng.transcribe_batch(x)
    layer = {"slice": {"busy_s": 0.0}}
    assert _metric("decode_enqueue_ms.offline").read(layer) > 0
    assert 0 < _metric("decode_sync_share.offline").read(layer) < 100
    assert _metric("engine_prep_ms.offline").read(layer) > 0
    assert _metric("encoder_device_ms.offline").read(layer) is None
