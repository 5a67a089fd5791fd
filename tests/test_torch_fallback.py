"""Temperature sampling and the fallback ladder: whisper_tpu_torch against
whisper_tpu.

* The quality gates and the schedule (``decode/fallback.py``) on the same
  strings and schedules: equal results.
* ``greedy_decode`` through the sampler: at T = 0 the tokens equal JAX's
  and ``sum_logprobs`` agrees within 1e-4; at T = 0.7 with the SAME
  injected noise (the port's ``draw_uniform`` and JAX's
  ``jax.random.fold_in``/``uniform`` replaced, in this test only, by one
  numpy table of ``u`` indexed by position) the picks are equal and
  ``sum_logprobs`` agrees within 1e-4.
* The engine's ladder against JAX's at ``dev`` f32: temperatures equal
  row by row; tokens and avg_logprob equal where no row samples at T > 0
  (the two packages draw different noise streams).
* The port alone: the same engine twice gives the same tokens, another
  ``sampling_seed`` diverges at T = 1, and the Gumbel-max pick samples
  ``softmax(logits / T)`` (4000 draws, atol 0.03).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode import fallback as jfallback
from whisper_tpu.decode import greedy as jgreedy
from whisper_tpu.decode.logits import make_rules as jax_make_rules
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode import fallback as tfallback
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=48)
EOT, SOT = 50257, 50258
MAX_NEW = 10

# --- gates and schedule ------------------------------------------------------

TEXTS = [
    "",
    "Mr Quilter is the apostle of the middle classes.",
    "the the the the the the the the the the the the the the the the",
    "ab" * 40,
    "日本語のテキスト、日本語のテキスト",
]


@pytest.mark.parametrize("text", TEXTS)
def test_compression_ratio_equal(text):
    assert tfallback.compression_ratio(text) == jfallback.compression_ratio(text)


@pytest.mark.parametrize("lp", [None, 0.0, -0.5, -1.0, -3.0])
@pytest.mark.parametrize("thresholds", [(2.4, -1.0), (None, -1.0), (2.4, None), (None, None)])
def test_needs_fallback_equal(lp, thresholds):
    for text in TEXTS:
        assert tfallback.needs_fallback(text, lp, *thresholds) == jfallback.needs_fallback(
            text, lp, *thresholds
        )


@pytest.mark.parametrize(
    "t0,ladder",
    [(0.0, None), (0.0, (0.2, 0.4, 0.6, 0.8, 1.0)), (0.4, (0.2, 0.4, 0.6, 1.0)),
     (0.0, (0.5, 0.3, 0.7)), (0.2, ())],
)
def test_normalize_schedule_equal(t0, ladder):
    assert tfallback.normalize_schedule(t0, ladder) == jfallback.normalize_schedule(t0, ladder)
    assert tfallback.DEFAULT_TEMPERATURES == jfallback.DEFAULT_TEMPERATURES


# --- greedy_decode through the sampler --------------------------------------


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(7)))
    enc = np.random.default_rng(8).standard_normal((3, 48, 64)).astype(np.float32)
    prompt = np.array([[SOT, SOT + 1 + lid, 50359, 50363] for lid in (0, 2, 6)], np.int32)
    rules = (
        jax_make_rules(JaxVocab.synthetic(multilingual=True), n_vocab=DIMS.n_vocab),
        make_rules(Vocab.synthetic(multilingual=True), n_vocab=DIMS.n_vocab),
    )
    return tree, params_from_jax(tree), enc, prompt, rules


def _sample_both(setup, temperature):
    tree, port, enc, prompt, (jr, tr) = setup
    jout = jgreedy.greedy_decode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(enc), jnp.asarray(prompt), DIMS, EOT,
        MAX_NEW, rules=jr, temperature=jnp.float32(temperature), rng=jax.random.PRNGKey(0),
        return_logprobs=True,
    )
    tout = tgreedy.greedy_decode(
        port, torch.from_numpy(enc), torch.from_numpy(prompt), T_DEV, EOT, MAX_NEW,
        rules=tr, temperature=temperature, generator=torch.Generator().manual_seed(0),
        return_logprobs=True,
    )
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_sampler_at_t0_is_greedy(setup):
    tree, port, enc, prompt, (jr, tr) = setup
    ref, ours = _sample_both(setup, 0.0)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4, atol=1e-4)
    assert (ours[2] < 0).all()
    plain = tgreedy.greedy_decode(
        port, torch.from_numpy(enc), torch.from_numpy(prompt), T_DEV, EOT, MAX_NEW, rules=tr
    )
    np.testing.assert_array_equal(ours[0], plain[0].numpy())  # the argmax path's tokens


def test_injected_noise_gives_equal_picks(setup, monkeypatch):
    _, _, _, prompt, _ = setup
    b = prompt.shape[0]
    total = prompt.shape[1] + MAX_NEW
    rng = np.random.default_rng(11)
    table = rng.uniform(size=(total, b, DIMS.n_vocab)).astype(np.float32)
    table = np.maximum(table, np.finfo(np.float32).tiny)
    jtable = jnp.asarray(table)

    # Both packages read u at the pick's position from the same table.
    monkeypatch.setattr(jax.random, "fold_in", lambda key, pos: pos)
    monkeypatch.setattr(jax.random, "uniform", lambda pos, shape, minval, maxval: jtable[pos])
    monkeypatch.setattr(tgreedy, "draw_uniform", lambda shape, pos, gen, dev: torch.from_numpy(table[pos]))
    ref, ours = _sample_both(setup, 0.7)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4, atol=1e-4)
    _, greedy = _sample_both(setup, 0.0)
    assert not np.array_equal(ours[0], greedy[0])  # the noise changed the picks


def test_temperature_needs_a_generator(setup):
    _, port, enc, prompt, _ = setup
    with pytest.raises(ValueError, match="Generator"):
        tgreedy.greedy_decode(
            port, torch.from_numpy(enc), torch.from_numpy(prompt), T_DEV, EOT, 2, temperature=0.5
        )


def test_uniform_draw_is_clamped(monkeypatch):
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
    u = tgreedy.draw_uniform((2, 3), 0, torch.Generator(), torch.device("cpu"))
    assert (u == torch.finfo(torch.float32).tiny).all()
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_gumbel_max_matches_softmax():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    for t in (1.0, 0.5):
        u = tgreedy.draw_uniform((4000, 4), 0, torch.Generator().manual_seed(3), torch.device("cpu"))
        picks = tgreedy.argmax_last(logits + t * -torch.log(-torch.log(u)))
        freq = np.bincount(picks.numpy(), minlength=4) / 4000
        want = torch.softmax(logits[0] / t, dim=-1).numpy()
        np.testing.assert_allclose(freq, want, atol=0.03)


# --- the engine's ladder against JAX's ---------------------------------------

CFG = dict(model="dev", language="en", dtype="float32", max_new_tokens=5)


@pytest.fixture(scope="module")
def jax_params():
    dims = JaxConfig(**CFG).dims()
    return jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (0.1 * rng.standard_normal((3, 16_000))).astype(np.float32)


ALWAYS = dict(logprob_threshold=1e9, compression_ratio_threshold=None)
NEVER = dict(logprob_threshold=-1e9, compression_ratio_threshold=None)
OFF = dict(logprob_threshold=None, compression_ratio_threshold=None)

LADDERS = {
    "gates_off": ("MONOLITH", dict(fallback_temperatures=(0.5,), **OFF), 0.0),
    "always_failing": ("MONOLITH", dict(fallback_temperatures=(0.5, 1.0), **ALWAYS), 1.0),
    "passing": ("MONOLITH", dict(fallback_temperatures=(0.5, 1.0), **NEVER), 0.0),
    "encdec_failing": ("ENCDEC", dict(fallback_temperatures=(1.0,), **ALWAYS), 1.0),
    "beam_primary_failing": ("MONOLITH", dict(beam_size=2, fallback_temperatures=(1.0,), **ALWAYS), 1.0),
    "beam_primary_passing": ("MONOLITH", dict(beam_size=2, fallback_temperatures=(1.0,), **NEVER), 0.0),
}


@pytest.mark.parametrize("name", sorted(LADDERS))
def test_ladder_equal_to_jax(jax_params, audio, name):
    kind, extra, last = LADDERS[name]
    x = audio[:2] if kind == "ENCDEC" or "beam" in name else audio
    ref = jax_create_engine(JaxType[kind], JaxConfig(**CFG, **extra), params=jax_params)
    ours = create_engine(
        EngineType[kind], EngineConfig(**CFG, **extra), params=params_from_jax(jax_params), device="cpu"
    )
    a, b = ref.transcribe_batch(x), ours.transcribe_batch(x)
    assert [r.temperature for r in b] == [r.temperature for r in a] == [last] * len(x)
    for r, o in zip(a, b):
        assert o.compression_ratio is not None and o.avg_logprob is not None
        if last == 0.0:  # nothing sampled at T > 0: the same tokens
            np.testing.assert_array_equal(o.tokens, r.tokens)
            assert o.text == r.text and o.compression_ratio == r.compression_ratio
            np.testing.assert_allclose(o.avg_logprob, r.avg_logprob, rtol=1e-4, atol=1e-4)


def test_no_ladder_leaves_the_fields_unset(audio):
    eng = create_engine(EngineType.MONOLITH, EngineConfig(**CFG), device="cpu")
    (r,) = eng.transcribe_batch(audio[:1])
    assert r.temperature is None and r.compression_ratio is None and r.words is None


@pytest.mark.parametrize(
    "extra,match", [(dict(beam_size=2, temperature=0.5), "beam"), (dict(temperature=-0.1), "temperature")]
)
def test_invalid_temperatures_raise(jax_params, extra, match):
    with pytest.raises(ValueError, match=match):
        jax_create_engine(JaxType.MONOLITH, JaxConfig(**CFG, **extra), params=jax_params)
    with pytest.raises(ValueError, match=match):
        create_engine(EngineType.MONOLITH, EngineConfig(**CFG, **extra), device="cpu")


def test_sampling_is_reproducible_and_seed_sensitive(audio):
    def run(eng):
        return [r.tokens[: r.length].tolist() for r in eng.transcribe_batch(audio)]

    e1 = create_engine(EngineType.MONOLITH, EngineConfig(**CFG, temperature=1.0), seed=0, device="cpu")
    e2 = create_engine(
        EngineType.MONOLITH, EngineConfig(**CFG, temperature=1.0, sampling_seed=1), seed=0, device="cpu"
    )
    first = run(e1)
    assert run(e1) == first
    assert run(e2) != first
    assert all(r.temperature == 1.0 for r in e1.transcribe_batch(audio))
