"""Long form: whisper_tpu_torch's ``transcribe_sequential`` (openai's seek
loop, ``decode/sequential.py``) and ``transcribe_long`` (VAD chunks in one
batch) against whisper_tpu's, at ``dev`` f32 on the CPU.

* The host helpers (``choose_prefix_len``, ``crop_prefix``,
  ``window_emit_and_advance``) on the same inputs: equal results.
* ``transcribe_sequential`` over 40 s of seeded noise with a 120-token
  budget (enough text for the previous-text prefix to reach the 31- and
  63-token crops), language fixed and detected, conditioning on and off:
  tokens, text, language and segments (start, end, text) equal.
* ``transcribe_long`` over audio built to give several VAD chunks, and over
  65 s of unbroken tone (hard splits): text, offsets and every chunk's
  tokens equal.
"""

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode import sequential as jseq
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode import sequential as tseq
from whisper_tpu_torch.engine import EngineType, LongTranscriptionResult, create_engine
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

BEG, EOT = 50364, 50257

# --- host helpers -------------------------------------------------------------


def test_prefix_helpers_equal():
    assert tseq.PREFIX_LENS == jseq.PREFIX_LENS
    assert (tseq.MIN_ADVANCE_SECONDS, tseq.WINDOW_SECONDS, tseq.TIME_PER_TOKEN) == (
        jseq.MIN_ADVANCE_SECONDS, jseq.WINDOW_SECONDS, jseq.TIME_PER_TOKEN
    )
    for n in range(0, 500):
        assert tseq.choose_prefix_len(n) == jseq.choose_prefix_len(n)
        prev = list(range(1000, 1000 + n))
        assert tseq.crop_prefix(prev) == jseq.crop_prefix(prev)


def _window_tokens(rng):
    """A generated token row mixing text, timestamps (pairs, singles) and
    an optional EOT with a tail."""
    out = []
    for _ in range(rng.integers(0, 14)):
        r = rng.random()
        if r < 0.45:
            out.append(int(rng.integers(0, 50257)))
        elif r < 0.9:
            out.append(BEG + int(rng.integers(0, 1501)))
        else:
            out.extend([EOT, int(rng.integers(0, 50257))])
    return out


def test_window_emit_and_advance_equal():
    rng = np.random.default_rng(21)
    cases = [[], [EOT], [BEG, 5, 6, BEG + 100], [BEG, 5, BEG + 50, BEG + 50, 7, BEG + 90],
             [BEG, 5, BEG + 10, BEG + 10]]
    cases += [_window_tokens(rng) for _ in range(400)]
    for toks in cases:
        assert tseq.window_emit_and_advance(toks, BEG, EOT) == jseq.window_emit_and_advance(
            toks, BEG, EOT
        ), toks


# --- the engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    dims = JaxConfig(model="dev").dims()
    return jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def seq_audio():
    rng = np.random.default_rng(0)
    return (0.05 * rng.standard_normal(16_000 * 40)).astype(np.float32)


SEQ_CFG = dict(model="dev", dtype="float32", max_new_tokens=120)


@pytest.fixture(scope="module")
def seq_engines(jax_params):
    """Per language setting: the JAX engine (its per-prompt-length programs
    compile once and serve both conditioning modes) and the port's."""
    out = {}
    for lang in ("en", None):
        cfg = dict(SEQ_CFG, language=lang)
        out[lang] = (
            jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax_params),
            create_engine(EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(jax_params),
                          device="cpu"),
        )
    return out


def _segments(result):
    return [(s.start, s.end, s.text, tuple(s.tokens)) for s in result.segments]


@pytest.mark.parametrize("condition", [True, False])
@pytest.mark.parametrize("lang", ["en", None])
def test_sequential_equal_to_jax(seq_engines, seq_audio, lang, condition):
    ref_engine, engine = seq_engines[lang]
    prompts = []
    window = engine._seq_window

    def spy(w, prompt, rules):
        prompts.append(len(prompt))
        return window(w, prompt, rules)

    engine._seq_window = spy
    try:
        ours = engine.transcribe_sequential(seq_audio, condition_on_previous_text=condition)
    finally:
        del engine._seq_window
    ref = ref_engine.transcribe_sequential(seq_audio, condition_on_previous_text=condition)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    assert ours.length == ref.length > 0
    assert ours.text == ref.text and ours.language == ref.language != ""
    assert _segments(ours) == _segments(ref) and len(ours.segments) > 1
    starts = [s.start for s in ours.segments]
    assert starts == sorted(starts)
    base = 3  # [sot, lang, transcribe]: timestamps on, no prefix
    assert len(prompts) > 1 and prompts[0] == base
    # Conditioning reaches the prefix crops only when on.
    assert (max(prompts) > base) == condition


def test_sequential_refuses_a_mesh(seq_audio):
    engine = create_engine(EngineType.MONOLITH, EngineConfig(**SEQ_CFG), device="cpu")
    engine.mesh = object()  # any mesh: the windows run on one rank only
    with pytest.raises(ValueError, match="mesh"):
        engine.transcribe_sequential(seq_audio[:16_000])


def _bursts(seconds, burst_at, seed):
    sr = 16_000
    rng = np.random.default_rng(seed)
    x = rng.normal(size=sr * seconds).astype(np.float32) * 0.001
    t = np.arange(sr) / sr
    burst = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    for s in burst_at:
        x[s * sr : s * sr + sr] += burst
    return x


LONG_AUDIO = {
    "vad_chunks": lambda: _bursts(75, [5, 20, 40, 70], 1),
    "hard_split": lambda: (0.2 * np.sin(2 * np.pi * 220 * np.arange(16_000 * 65) / 16_000)).astype(np.float32),
    "short": lambda: _bursts(5, [1], 2),
}


@pytest.mark.parametrize("kind", sorted(LONG_AUDIO))
def test_transcribe_long_equal_to_jax(jax_params, kind):
    x = LONG_AUDIO[kind]()
    cfg = dict(model="dev", dtype="float32", language="en", max_new_tokens=6)
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax_params).transcribe_long(x)
    ours = create_engine(
        EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(jax_params), device="cpu"
    ).transcribe_long(x)
    assert isinstance(ours, LongTranscriptionResult)
    assert ours.offsets == ref.offsets and ours.offsets == sorted(ours.offsets)
    assert ours.text == ref.text
    assert len(ours.chunks) == len(ref.chunks) == {"vad_chunks": 3, "hard_split": 3, "short": 1}[kind]
    for o, r in zip(ours.chunks, ref.chunks):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.length == r.length and o.text == r.text
