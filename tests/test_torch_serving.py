"""The port's AsyncTranscriber and StreamingSession against whisper_tpu's.

Both engines hold the same weights (``params_from_jax``) at ``dev`` dims,
float32, a 4-token budget. The micro-batcher's results must have tokens
EQUAL to JAX's engine on the same audio, its flushes must reach the engine
as full ``max_batch`` batches, grouped by the crop bucket exactly as JAX
groups them, and the streaming session must flush at the same points with
the same results as JAX's. Imports of the serving modules must leave JAX,
``whisper_tpu`` and ``triton`` unloaded (a subprocess).
"""

import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import Monolith as JaxMonolith
from whisper_tpu.engine import serving as jserving
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import N_SAMPLES, EngineConfig
from whisper_tpu_torch.engine import Monolith
from whisper_tpu_torch.engine import serving as tserving
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(model="dev", language="en", dtype="float32", max_new_tokens=4)
TIMEOUT = 120


def _noise(seconds=0.5, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16_000 * seconds))).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    dims = JaxConfig(**CFG).dims()
    tree = jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(9)))
    ref = JaxMonolith.from_assets(tree, JaxConfig(**CFG))
    ours = Monolith.from_assets(params_from_jax(tree), EngineConfig(**CFG), device="cpu")
    return ref, ours


UTTS = [_noise(seed=s) for s in range(6)]


@pytest.fixture(scope="module")
def expected(engines):
    """JAX's engine.transcribe of every utterance of UTTS, once."""
    return [engines[0].transcribe(u) for u in UTTS]


def _assert_tokens_equal(results, expected):
    for got, exp in zip(results, expected):
        assert got.length == exp.length
        np.testing.assert_array_equal(got.tokens[: got.length], exp.tokens[: exp.length])
        assert got.text == exp.text


class _Recorder:
    """An engine stand-in that records each flush's batch and which
    utterances it carried (by their samples), then runs the real engine."""

    def __init__(self, engine, utts=(), fail_on_nan=False):
        self.engine, self.config, self.dims = engine, engine.config, engine.dims
        self.utts, self.fail_on_nan = list(utts), fail_on_nan
        self.shapes, self.groups = [], []
        self._lock = threading.Lock()

    def transcribe_batch(self, batch):
        with self._lock:
            self.shapes.append(batch.shape)
            self.groups.append(sorted(
                i for i, u in enumerate(self.utts)
                if any(np.array_equal(row[: len(u)], u) and not row[len(u):].any() for row in batch)
            ))
        if self.fail_on_nan and np.isnan(batch).any():
            raise ValueError("poisoned batch")
        return self.engine.transcribe_batch(batch)


class TestAsyncTranscriber:
    def test_single_request(self, engines, expected):
        with tserving.AsyncTranscriber(engines[1], max_batch=4) as t:
            res = t.submit(UTTS[0]).result(timeout=TIMEOUT)
        _assert_tokens_equal([res], expected[:1])

    def test_concurrent_requests(self, engines, expected):
        with tserving.AsyncTranscriber(engines[1], max_batch=4, max_wait_ms=50) as t:
            results = [f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in UTTS]]
        _assert_tokens_equal(results, expected)

    def test_many_threads(self, engines, expected):
        """More submitting threads than the worker can serve at once, with
        a short switch interval: every request resolves to its own result."""
        results = [None] * (2 * len(UTTS))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with tserving.AsyncTranscriber(engines[1], max_batch=4, max_wait_ms=20) as t:

                def worker(i):
                    results[i] = t.submit(UTTS[i % len(UTTS)]).result(timeout=TIMEOUT)

                threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(results))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=TIMEOUT)
                assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(interval)
        _assert_tokens_equal(results, expected + expected)

    def test_status_callbacks(self, engines):
        seen = []
        with tserving.AsyncTranscriber(engines[1], on_status=seen.append) as t:
            t.submit(UTTS[0]).result(timeout=TIMEOUT)
        assert seen == [tserving.MSG_PROCESSING, tserving.MSG_DONE]
        assert (tserving.MSG_PROCESSING, tserving.MSG_DONE) == (jserving.MSG_PROCESSING, jserving.MSG_DONE)

    def test_submit_after_close_raises(self, engines):
        t = tserving.AsyncTranscriber(engines[1])
        t.close()
        with pytest.raises(RuntimeError):
            t.submit(UTTS[0])

    def test_error_isolation(self, engines, expected):
        """An engine failure fails its own flush's futures; the loop goes on
        serving. A zero-length request is served (zero-padded)."""
        rec = _Recorder(engines[1], fail_on_nan=True)
        poison = UTTS[1].copy()
        poison[3] = np.nan
        with tserving.AsyncTranscriber(rec, max_batch=1) as t:
            bad = t.submit(poison)
            empty = t.submit(np.zeros((0,), np.float32))
            good = t.submit(UTTS[0])
            with pytest.raises(ValueError, match="poisoned"):
                bad.result(timeout=TIMEOUT)
            assert empty.result(timeout=TIMEOUT).length >= 2
            _assert_tokens_equal([good.result(timeout=TIMEOUT)], expected[:1])

    def test_every_flush_padded_to_max_batch(self, engines):
        rec = _Recorder(engines[1])
        with tserving.AsyncTranscriber(rec, max_batch=4, max_wait_ms=20) as t:
            t.submit(UTTS[0]).result(timeout=TIMEOUT)  # a singleton
            [f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in UTTS[1:3]]]  # a pair
            [f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in UTTS]]  # a burst above max_batch
        assert len(rec.shapes) >= 4
        assert set(rec.shapes) == {(4, N_SAMPLES)}

    def test_bucket_of_equal_to_jax(self, engines):
        jt = jserving.AsyncTranscriber(engines[0])
        tt = tserving.AsyncTranscriber(engines[1])
        try:
            for seconds in (0.0, 0.3, 4.0, 4.5, 9.0, 9.7, 19.0, 20.6, 29.0, 31.0):
                x = _noise(seconds, seed=int(seconds * 10))
                x_padded = np.concatenate([x, np.zeros(16_000, np.float32)])  # a zero-padded buffer
                for y in (x, x_padded):
                    assert tt._bucket_of(y) == jt._bucket_of(y)
        finally:
            jt.close()
            tt.close()

    def test_mixed_lengths_grouped_as_jax_groups_them(self, engines):
        """Short and long utterances interleaved: the flushes carry the same
        groups on both sides (the short ones cropped together), and the
        results equal JAX's engine."""
        rng = np.random.default_rng(0)
        short = [(0.1 * rng.standard_normal(16_000)).astype(np.float32) for _ in range(3)]
        long_ = [(0.1 * rng.standard_normal(470_000)).astype(np.float32) for _ in range(3)]
        utts = [short[0], long_[0], short[1], long_[1], short[2], long_[2]]
        groups, results = [], []
        for mod, engine in ((jserving, engines[0]), (tserving, engines[1])):
            rec = _Recorder(engine, utts)
            # A wait longer than any flush here: every flush is of a full
            # bucket, whatever the engine's speed.
            with mod.AsyncTranscriber(rec, max_batch=3, max_wait_ms=10_000) as t:
                results.append([f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in utts]])
            groups.append(rec.groups)
        assert groups[1] == groups[0] == [[0, 2, 4], [1, 3, 5]]
        _assert_tokens_equal(results[1], results[0])

    def test_head_of_queue_never_starved(self, engines):
        rng = np.random.default_rng(1)
        # One lone long utterance among many short ones: it must still resolve.
        utts = [(0.1 * rng.standard_normal(470_000)).astype(np.float32)] + [
            (0.1 * rng.standard_normal(16_000)).astype(np.float32) for _ in range(5)
        ]
        rec = _Recorder(engines[1], utts)
        with tserving.AsyncTranscriber(rec, max_batch=4, max_wait_ms=20) as t:
            results = [f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in utts]]
        assert all(r.length >= 2 for r in results)
        assert any(0 in g for g in rec.groups)

    def test_warmup_runs_every_crop_bucket(self, engines):
        rec = _Recorder(engines[1])
        t = tserving.AsyncTranscriber(rec, max_batch=2)
        try:
            t.warmup()
        finally:
            t.close()
        # The three crop buckets and the full window, each at max_batch rows.
        assert [s[0] for s in rec.shapes] == [2, 2, 2, 2]
        assert rec.shapes[-1] == (2, N_SAMPLES)


class _Recording:
    """A transcriber stand-in for StreamingSession: records each
    utterance's length, then transcribes it through the real one."""

    def __init__(self, transcriber):
        self.transcriber, self.lengths = transcriber, []

    def transcribe(self, samples):
        self.lengths.append(len(samples))
        return self.transcriber.submit(samples).result(timeout=TIMEOUT)


def _stream(mod, engine, buffers, **kw):
    results, updates = [], []
    with mod.AsyncTranscriber(engine, max_batch=2) as t:
        rec = _Recording(t)
        sess = mod.StreamingSession(rec, on_result=results.append, on_update=updates.append, **kw)
        for b in buffers:
            sess.write_buffer(b)
        sess.stop()
    return rec.lengths, results, updates


@pytest.mark.parametrize(
    "case", ["mic", "vad"],
)
def test_streaming_session_equal_to_jax(engines, case):
    """The mic pipeline (35 s in 5 s blocks: a 30 s flush mid-stream and a
    final one) and the VAD flush (a trailing silence ends the utterance):
    the same flush points and the same results as JAX's session."""
    if case == "mic":
        buffers = [_noise(5.0, seed=s) for s in range(7)]
        kw = dict(use_vad=False)
    else:
        buffers = [_noise(1.0), np.zeros(4_096, np.float32), _noise(0.6, seed=2)]
        kw = dict(use_vad=True, min_chunk_samples=8_000)
    j_lengths, j_results, j_updates = _stream(jserving, engines[0], buffers, **kw)
    t_lengths, t_results, t_updates = _stream(tserving, engines[1], buffers, **kw)
    assert t_lengths == j_lengths
    assert t_updates == j_updates == [tserving.MSG_PROCESSING] * len(j_lengths)
    assert len(j_lengths) == 2
    if case == "mic":
        assert j_lengths == [N_SAMPLES, 5 * 16_000]
    _assert_tokens_equal(t_results, j_results)


def test_serving_imports_leave_jax_out():
    """Importing the serving layer pulls in neither JAX, the JAX package nor
    triton."""
    code = (
        "import sys\n"
        "import whisper_tpu_torch.engine.serving, whisper_tpu_torch.engine.http_server\n"
        "import whisper_tpu_torch.decode.continuous, whisper_tpu_torch.audio.vad\n"
        "import whisper_tpu_torch.utils.profiling, whisper_tpu_torch.audio\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'whisper_tpu', 'triton')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
