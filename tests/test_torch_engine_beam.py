"""whisper_tpu_torch's engine with beam search, int8 weights and the fp8 KV
cache, against whisper_tpu's engine, end to end.

The JAX engine's parameters are handed to the port; both transcribe the
same audio with MONOLITH at float32, ``dev`` dims, ``beam_size=3``.
Tokens, lengths, text and the detected language must be EQUAL;
``avg_logprob`` (the beam's length-normalised score) agrees to 1e-4. The
second case adds ``quantization="int8"`` and
``kv_cache_dtype="float8_e4m3fn"``: both engines quantize the same float
weights at construction.
"""

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

CFG = dict(model="dev", dtype="float32", max_new_tokens=10, beam_size=3)


@pytest.fixture(scope="module")
def jax_params():
    dims = JaxConfig(**CFG).dims()
    return jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(5)))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (220 + 60 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(quantization="int8", kv_cache_dtype="float8_e4m3fn")],
    ids=["float", "int8+fp8"],
)
def test_beam_engine_equal_to_jax(jax_params, extra):
    cfg = dict(CFG, **extra)
    x = np.zeros((2, 48_000), np.float32)
    x[0], x[1, :40_000] = _audio(3.0, 1), _audio(2.5, 2)
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax_params)
    ours = create_engine(
        EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(jax_params), device="cpu"
    )
    if extra:
        assert isinstance(ours.assets.params["decoder"]["tok_emb"], dict)
    a, b = ref.transcribe_batch(x), ours.transcribe_batch(x)
    for r, o in zip(a, b):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.length == r.length
        assert o.text == r.text
        assert o.language == r.language and o.language != ""
        np.testing.assert_allclose(o.avg_logprob, r.avg_logprob, rtol=1e-4, atol=1e-4)


def test_silence_gate_override():
    eng = create_engine(
        EngineType.MONOLITH,
        EngineConfig(model="dev", max_new_tokens=2, beam_size=2, no_speech_threshold=0.5),
        device="cpu",
    )
    row = np.asarray(eng._prompt).tolist() + [eng.vocab.specials.eot] * 2
    gated = eng.result_from_tokens(np.array(row), len(eng._prompt) + 1, no_speech_prob=0.9, avg_logprob=-3.0)
    kept = eng.result_from_tokens(np.array(row), len(eng._prompt) + 1, no_speech_prob=0.9, avg_logprob=-0.5)
    assert gated.is_silent and not kept.is_silent  # logprob_threshold -1.0 overrides


def test_unknown_quantization_raises():
    with pytest.raises(ValueError):
        create_engine(EngineType.MONOLITH, EngineConfig(model="dev", quantization="int4"), device="cpu")
