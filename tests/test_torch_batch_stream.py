"""``Monolith.transcribe_batches``, the double-buffered batch stream, against
whisper_tpu's on the CPU at ``dev`` dims f32.

Three batches of 1, 3 and 2 rows (batch buckets 1, 4 and 2) whose content
ends at 2, 8 and 25 s, so that ``audio_ctx="auto"`` crops each at another
bucket (256, 512 and the full window), go through JAX's
``Monolith.transcribe_batches`` and the port's on the same weights
(``params_from_jax``); tokens, lengths, text and language must be equal for
greedy with language detection, beam 3 with int8 weights and the fp8 KV
cache, a ``dev`` draft at k = 3, and ``no_speech_threshold``. An empty
sequence gives ``[]``. The paths that take the sequential base (a fallback
ladder, word timestamps, ``EncDec``) equal a loop of ``transcribe_batch``
and never enter the stream. A recorded call log shows the pipeline's shape
where no card is present: batch i+1's encode is entered before batch i's
decode, and batch i+2's before batch i's results are built.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
from whisper_tpu_torch.engine.engine import snap_audio_ctx
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

BASE = dict(model="dev", dtype="float32", max_new_tokens=8)  # language None: detection
CASES = {
    "greedy": {},
    "beam3_int8_fp8": dict(beam_size=3, quantization="int8", kv_cache_dtype="float8_e4m3fn"),
    "draft": dict(draft_model="dev", k_draft=3),
    "no_speech": dict(no_speech_threshold=0.02),
}
# (rows, seconds of content) of each batch: buckets 1, 4, 2; crops 256, 512, full.
SHAPES = ((1, 2.0), (3, 8.0), (2, 25.0))


@pytest.fixture(scope="module")
def trees():
    dims = JaxConfig(model="dev").dims()
    return jax_init_params(dims, jax.random.PRNGKey(21)), jax_init_params(dims, jax.random.PRNGKey(22))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(7)
    out = []
    for rows, seconds in SHAPES:
        n = int(16_000 * seconds)
        t = np.arange(n) / 16_000
        x = np.stack([
            0.2 * np.sin(2 * np.pi * (150 + 90 * r) * t) + 0.05 * rng.standard_normal(n)
            for r in range(rows)
        ])
        x[1:, n // 2 :] = 0  # shorter rows: the batch's last content sets its crop
        out.append(x.astype(np.float32))
    return out


def _port(trees, kind=EngineType.MONOLITH, **over):
    target, draft = trees
    kw = {}
    if "draft_model" in over:
        kw["draft_params"] = params_from_jax(jax.tree.map(np.asarray, draft))
    return create_engine(kind, EngineConfig(**BASE, **over),
                         params=params_from_jax(jax.tree.map(np.asarray, target)), device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(trees, batches):
    """Per case, (whisper_tpu's transcribe_batches, the port's) on the
    three batches, each engine built once."""

    @functools.lru_cache(maxsize=None)
    def run(case):
        over = CASES[case]
        target, draft = trees
        jax_kw = {"draft_params": draft} if "draft_model" in over else {}  # jnp: see ROADMAP Queue 3
        ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**BASE, **over), params=target, **jax_kw)
        return ref.transcribe_batches(batches), _port(trees, **over).transcribe_batches(batches)

    return run


def test_the_batches_crop_and_bucket_differently(batches, trees):
    engine = _port(trees)
    seen = []
    for b in batches:
        host, rows, _ = engine._prepare_batch(b)
        seen.append((host.shape[0], engine._resolve_audio_ctx(host)))
    assert seen == [(1, 256), (4, 512), (2, None)]
    assert snap_audio_ctx(16_000 * 25, engine.dims.n_audio_ctx) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equal_to_jax(runs, case):
    ref, ours = runs(case)
    assert [len(x) for x in ours] == [len(x) for x in ref] == [rows for rows, _ in SHAPES]
    for o_list, r_list in zip(ours, ref):
        for o, r in zip(o_list, r_list):
            np.testing.assert_array_equal(o.tokens, r.tokens)
            assert o.length == r.length
            assert o.text == r.text
            assert o.language == r.language != ""
            assert o.is_silent == r.is_silent


def test_stream_equal_to_the_loop_and_records_each_batch(trees, batches):
    """The stream's results equal a loop of ``transcribe_batch`` on the same
    engine, and it records each batch's time and throughput once."""
    engine = _port(trees, **CASES["no_speech"])
    loop = [engine.transcribe_batch(b) for b in batches]
    before = engine.throughput.utterances
    ours = engine.transcribe_batches(batches)
    assert engine.throughput.utterances - before == sum(rows for rows, _ in SHAPES)
    for o_list, l_list in zip(ours, loop):
        for o, r in zip(o_list, l_list):
            np.testing.assert_array_equal(o.tokens, r.tokens)
            assert (o.length, o.text, o.language) == (r.length, r.text, r.language)
            assert o.no_speech_prob == pytest.approx(r.no_speech_prob, rel=1e-6, abs=1e-7)
            assert o.model_ms > 0


def test_speculative_stats_belong_to_the_last_batch(trees, batches):
    engine = _port(trees, **CASES["draft"])
    engine.transcribe_batches(batches)
    stream = engine.last_spec_stats
    engine.transcribe_batch(batches[-1])
    assert stream == engine.last_spec_stats


def test_empty_sequence(trees):
    assert _port(trees).transcribe_batches([]) == []
    assert jax_create_engine(JaxType.MONOLITH, JaxConfig(**BASE), params=trees[0]).transcribe_batches([]) == []


def test_call_order_witness(trees, batches):
    """Batch i+1's encode is entered before batch i's decode, and batch
    i+2's before batch i's results are built: the pipeline of depth 2."""
    engine = _port(trees)
    log = []

    def spy(name, fn):
        count = iter(range(len(batches)))

        def wrapped(*a, **kw):
            log.append((name, next(count)))
            return fn(*a, **kw)

        return wrapped

    for name in ("_stream_encode", "_stream_decode", "_stream_results"):
        setattr(engine, name, spy(name, getattr(engine, name)))
    out = engine.transcribe_batches(batches)
    assert len(out) == len(batches)
    at = {entry: k for k, entry in enumerate(log)}
    n = len(batches)
    for i in range(n):
        assert at["_stream_encode", i] < at["_stream_decode", i] < at["_stream_results", i]
        if i + 1 < n:
            assert at["_stream_encode", i + 1] < at["_stream_decode", i]
        if i + 2 < n:
            assert at["_stream_encode", i + 2] < at["_stream_results", i]
    assert log == [
        ("_stream_encode", 0), ("_stream_encode", 1), ("_stream_decode", 0),
        ("_stream_encode", 2), ("_stream_results", 0), ("_stream_decode", 1),
        ("_stream_results", 1), ("_stream_decode", 2), ("_stream_results", 2),
    ]


FALLBACKS = {
    "ladder": (EngineType.MONOLITH, dict(fallback_temperatures=(0.5,), logprob_threshold=1e9,
                                         compression_ratio_threshold=None)),
    "words": (EngineType.MONOLITH, dict(word_timestamps=True)),
    "encdec": (EngineType.ENCDEC, {}),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_equal_the_sequential_base(trees, batches, case, monkeypatch):
    kind, over = FALLBACKS[case]
    engine = _port(trees, kind, **over)

    def never(*a, **kw):
        raise AssertionError("this configuration takes the sequential base")

    monkeypatch.setattr(Monolith, "_stream_stage", never)
    loop = [engine.transcribe_batch(b) for b in batches]
    ours = engine.transcribe_batches(batches)
    for o_list, l_list in zip(ours, loop):
        assert len(o_list) == len(l_list)
        for o, r in zip(o_list, l_list):
            np.testing.assert_array_equal(o.tokens, r.tokens)
            assert (o.length, o.text, o.temperature) == (r.length, r.text, r.temperature)
            if case == "words":
                assert [(w.word, w.start, w.end) for w in o.words] == [
                    (w.word, w.start, w.end) for w in r.words
                ]
