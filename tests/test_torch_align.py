"""Word timestamps: whisper_tpu_torch.decode.align and the engine's
alignment forward against whisper_tpu's.

* ``alignment_matrix`` on the same tokens and the same head-major cross-KV
  (f32, and stored in fp8 as the fp8 KV cache stores it), default and
  explicit alignment heads: within 1e-4 (f32 sums in another order).
* The host pipeline (median filter, DTW, token boundaries, words) on one
  matrix: equal output.
* The engine with ``word_timestamps=True`` at ``dev`` f32 over a vocab
  whose surfaces start words (every even token begins with a space):
  words equal to JAX's, tokens equal to a run without the flag, and
  ``0 <= start <= end <= 30``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode import align as jalign
from whisper_tpu.engine import EncDec as JaxEncDec
from whisper_tpu.engine import Monolith as JaxMonolith
from whisper_tpu.models.decoder import precompute_cross_kv as jax_cross_kv
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode import align as talign
from whisper_tpu_torch.engine import EncDec, Monolith
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=80)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=80)


@pytest.fixture(scope="module")
def matrix_inputs():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(4)))
    enc = np.random.default_rng(5).standard_normal((2, 80, 64)).astype(np.float32)
    cross = jax.tree.map(np.array, jax_cross_kv(jax.tree.map(jnp.asarray, tree), jnp.asarray(enc), DIMS))
    toks = np.random.default_rng(6).integers(0, 50257, size=(2, 9)).astype(np.int32)
    return tree, params_from_jax(tree), cross, toks


def _fp8(x: np.ndarray):
    """The same fp8 bytes on both sides: numpy (ml_dtypes) and torch."""
    q = x.astype(ml_dtypes.float8_e4m3fn)
    return q, torch.from_numpy(q.view(np.uint8).copy()).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("heads", [None, ((0, 1), (1, 0))])
@pytest.mark.parametrize("store", ["float32", "float8_e4m3fn"])
def test_alignment_matrix_equal_to_jax(matrix_inputs, heads, store):
    tree, port, cross, toks = matrix_inputs
    mask = jalign.default_alignment_mask(DIMS) if heads is None else jalign.heads_to_mask(heads, DIMS)
    tmask = talign.default_alignment_mask(T_DEV) if heads is None else talign.heads_to_mask(heads, T_DEV)
    np.testing.assert_array_equal(tmask, mask)
    if store == "float32":
        jcross = {n: jnp.asarray(v) for n, v in cross.items()}
        tcross = {n: torch.from_numpy(v) for n, v in cross.items()}
    else:
        pairs = {n: _fp8(v) for n, v in cross.items()}
        jcross = {n: jnp.asarray(p[0]) for n, p in pairs.items()}
        tcross = {n: p[1] for n, p in pairs.items()}
    ref = np.asarray(jalign.alignment_matrix(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jcross, DIMS, jnp.asarray(mask)
    ))
    got = talign.alignment_matrix(port, torch.from_numpy(toks), tcross, T_DEV, tmask).numpy()
    assert got.shape == ref.shape == (2, 9, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


class _WordVocab:
    """Surfaces for both packages' Vocab: every even text token starts a
    word (a leading space), so rows split into several words."""

    @staticmethod
    def table():
        return {i: (b" w%d" % i if i % 2 == 0 else b"x%d" % i) for i in range(50257)}


def test_host_pipeline_equal_to_jax():
    rng = np.random.default_rng(9)
    matrix = rng.standard_normal((14, 120)).astype(np.float32)
    filt = talign.median_filter(matrix, 7)
    np.testing.assert_array_equal(filt, jalign.median_filter(matrix, 7))
    path = talign.dtw_path(-filt.astype(np.float64))
    ref_path = jalign.dtw_path(-filt.astype(np.float64))
    for a, b in zip(path, ref_path):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        talign.token_boundaries(*path, 10), jalign.token_boundaries(*ref_path, 10)
    )
    tv = Vocab(_WordVocab.table(), multilingual=True, n_vocab=51865)
    jv = JaxVocab(_WordVocab.table(), multilingual=True, n_vocab=51865)
    tokens = np.concatenate([[50258, 50259, 50359, 50363], rng.integers(0, 50257, 9), [50257]])
    assert talign.split_words(tv, tokens[4:]) == jalign.split_words(jv, tokens[4:])
    words = talign.words_from_alignment(tv, tokens, 14, 4, matrix, n_frames=100)
    ref = jalign.words_from_alignment(jv, tokens, 14, 4, matrix, n_frames=100)
    assert len(words) > 1
    assert [dataclasses.astuple(w) for w in words] == [dataclasses.astuple(w) for w in ref]


CFG = dict(model="dev", dtype="float32", max_new_tokens=8, word_timestamps=True)
CASES = {
    "greedy_detect": (Monolith, dict()),
    "encdec_fixed_language": (EncDec, dict(language="en", audio_ctx=None)),
    "beam_fp8_heads": (Monolith, dict(beam_size=2, kv_cache_dtype="float8_e4m3fn",
                                       alignment_heads=((1, 0), (1, 1), (0, 1)))),
}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init_params(JaxConfig(model="dev").dims(), jax.random.PRNGKey(3)))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_words_equal_to_jax(jax_params, name):
    cls, extra = CASES[name]
    x = np.zeros((2, 16_000 * 4), np.float32)
    x[0, : 16_000 * 3] = _audio(3.0, 1)
    x[1] = _audio(4.0, 2)
    jvocab = JaxVocab(_WordVocab.table(), multilingual=True, n_vocab=51865)
    tvocab = Vocab(_WordVocab.table(), multilingual=True, n_vocab=51865)
    jcls = JaxMonolith if cls is Monolith else JaxEncDec
    ref = jcls.from_assets(jax_params, JaxConfig(**CFG, **extra), vocab=jvocab).transcribe_batch(x)
    port = params_from_jax(jax_params)
    ours = cls.from_assets(port, EngineConfig(**CFG, **extra), vocab=tvocab, device="cpu").transcribe_batch(x)
    plain_cfg = EngineConfig(**dict(CFG, word_timestamps=False), **extra)
    plain = cls.from_assets(port, plain_cfg, vocab=tvocab, device="cpu").transcribe_batch(x)
    assert any(len(o.words) > 1 for o in ours)
    for r, o, p in zip(ref, ours, plain):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        np.testing.assert_array_equal(o.tokens, p.tokens)
        assert p.words is None
        assert [dataclasses.astuple(w) for w in o.words] == [dataclasses.astuple(w) for w in r.words]
        for w in o.words:
            assert 0.0 <= w.start <= w.end <= 30.0
        starts = [w.start for w in o.words]
        assert starts == sorted(starts)
