"""Engine-level differential tests of configs that earlier probes found equal
to whisper_tpu's but that no test held, at ``dev`` dims f32 on the CPU:

* ``reference_quirks=True`` with ``task="translate"`` and language
  detection (the literal prompt keeps the transcribe token), also on a
  stereo WAV file (the reference's downmix);
* ``task="translate"`` with language detection;
* speculative decoding (a ``dev`` draft, k = 2) with int8 weights, the fp8
  KV cache, language detection and timestamps;
* ``EncDec`` with word timestamps and int8 weights.

Each case builds whisper_tpu's engine and the port's once, on the same
parameters (``params_from_jax``), and compares tokens, length, text,
language, segments and words on one batch. JAX gets its draft as a ``jnp``
tree: a numpy tree of float weights fails inside its ``jit`` (ROADMAP
Queue 3).
"""

import functools
import wave

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

BASE = dict(model="dev", dtype="float32", max_new_tokens=8)  # language None: detection
CASES = {
    "reference_quirks": ("monolith", dict(reference_quirks=True, task="translate")),
    "translate": ("monolith", dict(task="translate")),
    "speculative": ("monolith", dict(draft_model="dev", k_draft=2, quantization="int8",
                                     kv_cache_dtype="float8_e4m3fn", timestamps=True)),
    "encdec_words": ("encdec", dict(word_timestamps=True, quantization="int8")),
}
TYPES = {"monolith": (JaxType.MONOLITH, EngineType.MONOLITH),
         "encdec": (JaxType.ENCDEC, EngineType.ENCDEC)}


@pytest.fixture(scope="module")
def trees():
    dims = JaxConfig(model="dev").dims()
    return jax_init_params(dims, jax.random.PRNGKey(11)), jax_init_params(dims, jax.random.PRNGKey(12))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    t = np.arange(16_000 * 2) / 16_000
    tone = 0.2 * np.sin(2 * np.pi * 330 * t)
    return np.stack([tone + 0.05 * rng.standard_normal(t.size),
                     0.1 * rng.standard_normal(t.size)]).astype(np.float32)


@pytest.fixture(scope="module")
def results(trees, batch):
    """Per case, (whisper_tpu's results, the port's, the port's engine,
    whisper_tpu's engine) on the batch, each engine built once."""
    target, draft = trees

    @functools.lru_cache(maxsize=None)
    def run(case):
        kind, over = CASES[case]
        jax_type, port_type = TYPES[kind]
        cfg = dict(BASE, **over)
        jax_kw, port_kw = {}, {}
        if "draft_model" in over:
            jax_kw["draft_params"] = draft  # jnp
            port_kw["draft_params"] = params_from_jax(jax.tree.map(np.asarray, draft))
        ref = jax_create_engine(jax_type, JaxConfig(**cfg), params=target, **jax_kw)
        ours = create_engine(port_type, EngineConfig(**cfg),
                             params=params_from_jax(jax.tree.map(np.asarray, target)),
                             device="cpu", **port_kw)
        return ref.transcribe_batch(batch), ours.transcribe_batch(batch), ours, ref

    return run


def _segments(r):
    return None if r.segments is None else [(s.start, s.end, s.text, tuple(s.tokens)) for s in r.segments]


def _words(r):
    return None if r.words is None else [(w.word, w.start, w.end, tuple(w.tokens)) for w in r.words]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_equal_to_jax(results, case):
    ref, ours, _, _ = results(case)
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.length == r.length
        assert o.text == r.text
        assert o.language == r.language != ""
        assert _segments(o) == _segments(r)
        assert _words(o) == _words(r)


def test_options_reach_the_outputs(results):
    """Each option shows where it should: the quirk keeps the transcribe
    token where translate puts its own, timestamps give segments, words
    come with word timestamps, and the draft ran rounds."""
    _, quirks, _, _ = results("reference_quirks")
    _, translate, _, _ = results("translate")
    assert [int(r.tokens[2]) for r in quirks] == [50359] * 2
    assert [int(r.tokens[2]) for r in translate] == [50358] * 2
    assert all(r.segments is None and r.words is None for r in quirks + translate)
    _, spec, spec_engine, _ = results("speculative")
    assert all(r.segments is not None for r in spec)
    assert spec_engine.last_spec_stats["rounds"] >= 1
    _, words, _, _ = results("encdec_words")
    assert all(r.words is not None for r in words)


def test_reference_quirks_stereo_wav_equal_to_jax(results, batch, tmp_path):
    """A stereo 16-bit WAV through ``transcribe(path)``: both engines read
    it with the reference's downmix (the channel sum over INT32_MAX) and
    agree on the result."""
    _, _, ours, ref = results("reference_quirks")
    left, right = (np.clip(x * 32767, -32768, 32767).astype("<i2") for x in batch)
    path = tmp_path / "stereo.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(np.stack([left, right], axis=1).tobytes())
    a, b = ours.transcribe(str(path)), ref.transcribe(str(path))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.length == b.length and a.text == b.text and a.language == b.language != ""
