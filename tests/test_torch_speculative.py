"""Speculative decoding in the port against whisper_tpu, on the CPU.

The same weights (``params_from_jax``) and inputs go through JAX's
function and the port's, at ``dev`` width in float32:

* ``decoder_window`` (T > 1 at per-row positions): logits within 1e-5 of
  JAX's, the cache rows it writes within 1e-5 (f32) or byte-equal (fp8,
  where rounding the same f32 value gives the same byte); past
  ``n_text_ctx`` the position gather clamps, and the rows inside the
  context keep the logits of a window that stops there;
* ``speculative_greedy_decode``: tokens, lengths and stats equal to JAX's
  (an unrelated draft at k = 1, 3, 4, a self-draft, rules + bias, EOT
  freeze, no-speech probabilities), and tokens equal to JAX's
  ``greedy_decode``;
* a budget that fills the 448-token context: tokens equal to JAX's
  ``greedy_decode`` for a self-draft and an unrelated draft. JAX's own
  speculative decode leaves greedy there (its per-row position gather
  fills NaN past the table), so the port is held to greedy;
* a draft one vocabulary id short of the target (tiny under large-v3):
  tokens equal to JAX's ``greedy_decode`` of the target;
* the engine: ``Monolith`` with a ``dev`` draft and with a draft of its
  own frontend (a 128-mel ``dev`` target, the 80-mel ``dev`` draft)
  against JAX's engine; ``EncDec`` with a shared-encoder draft; and the
  refusals (beam + draft, sampling + draft, ``EncDec`` + foreign frontend,
  a draft of another width without its encoder output).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.config as jax_config
import whisper_tpu_torch.config as torch_config
from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode.greedy import greedy_decode as jax_greedy
from whisper_tpu.decode.logits import make_rules as jax_make_rules
from whisper_tpu.decode.speculative import speculative_greedy_decode as jax_spec
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models import decoder as jdec
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu.tokenizer.vocab import num_languages_for
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.decode.speculative import speculative_greedy_decode
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models import decoder as tdec
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = MODEL_DIMS["dev"]
T_DEV = T_DIMS["dev"]
EOT = 50257
PROMPT = np.array([[50258, 50259, 50359, 50363]] * 3, np.int32)


def _tree(seed, dims=DIMS):
    return jax_init_params(dims, jax.random.PRNGKey(seed))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def setup():
    pt, pd = _tree(0), _tree(7)  # target, unrelated draft
    enc = (0.3 * np.random.default_rng(1).standard_normal((3, DIMS.n_audio_ctx, 64))).astype(np.float32)
    return pt, pd, _port(pt), _port(pd), enc


def _both(setup, draft, max_new, k, **kw):
    """JAX's speculative decode and the port's on the same inputs; ``kw``
    holds numpy rules/bias pairs as (jax, torch)."""
    pt, pd, tpt, tpd, enc = setup
    jd, td = (pt, tpt) if draft == "self" else (pd, tpd)
    jkw = {n: v[0] for n, v in kw.items()}
    tkw = {n: v[1] for n, v in kw.items()}
    ref = jax_spec(pt, jd, jnp.asarray(enc), jnp.asarray(PROMPT), DIMS, DIMS, eot=EOT,
                   max_new_tokens=max_new, k_draft=k, **jkw)
    got = speculative_greedy_decode(tpt, td, torch.from_numpy(enc), torch.from_numpy(PROMPT), T_DEV,
                                    T_DEV, eot=EOT, max_new_tokens=max_new, k_draft=k, **tkw)
    greedy = jax_greedy(pt, jnp.asarray(enc), jnp.asarray(PROMPT), DIMS, eot=EOT,
                        max_new_tokens=max_new, **{n: v for n, v in jkw.items() if n != "no_speech"})
    return ref, got, greedy


def _assert_equal(ref, got, greedy):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(greedy[0]))
    assert got[2] == {n: int(v) for n, v in ref[2].items()}


# --- decoder_window ---------------------------------------------------------

WIN_POS = [5, 4, 7]  # each row's first window position
WIN_TOK = [[11, 400, 3, 60], [12, 7, 3, 2], [13, 9, 501, 77]]
CTX = 16


def _window_jax(pt, enc, kv):
    xkv = jdec.precompute_cross_kv(pt, jnp.asarray(enc), DIMS)
    cache = jdec.init_kv_cache(DIMS, 3, CTX, dtype=kv or jnp.float32)
    prompt = np.tile(np.array([[50258, 50259, 50359, 50363, 300, 301, 302]], np.int32), (3, 1))
    _, cache = jdec.decoder_prefill(pt, jnp.asarray(prompt), cache, xkv, DIMS)
    logits, cache = jdec.decoder_window(pt, jnp.asarray(WIN_TOK, jnp.int32),
                                        jnp.asarray(WIN_POS, jnp.int32), cache, xkv, DIMS)
    return np.asarray(logits), {n: np.asarray(cache[n]) for n in "kv"}


def _window_port(tpt, enc, kv, ctx=CTX, pos=WIN_POS, tok=WIN_TOK, dims=T_DEV):
    xkv = tdec.precompute_cross_kv(tpt, torch.from_numpy(enc), dims)
    cache = tdec.init_kv_cache(dims, 3, ctx, dtype=kv or torch.float32)
    prompt = torch.tensor([[50258, 50259, 50359, 50363, 300, 301, 302]] * 3)
    _, cache = tdec.decoder_prefill(tpt, prompt, cache, xkv, dims)
    logits, cache = tdec.decoder_window(tpt, torch.tensor(tok), torch.tensor(pos), cache, xkv, dims)
    return logits, cache


@pytest.mark.parametrize("kv", ["float32", "float8_e4m3fn"])
def test_decoder_window_equal_to_jax(setup, kv):
    pt, _, tpt, _, enc = setup
    ref, ref_cache = _window_jax(pt, enc, None if kv == "float32" else jnp.float8_e4m3fn)
    got, cache = _window_port(tpt, enc, None if kv == "float32" else torch.float8_e4m3fn)
    assert got.shape == (3, 4, DIMS.n_vocab)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    for n in "kv":
        for b, p0 in enumerate(WIN_POS):
            rows = slice(p0, p0 + len(WIN_TOK[0]))
            a, r = cache[n][:, b, rows], ref_cache[n][:, b, rows]
            if kv == "float32":
                np.testing.assert_allclose(a.numpy(), r, atol=1e-5)
            else:
                np.testing.assert_array_equal(a.view(torch.uint8).numpy(), r.view(np.uint8))
            # Past the window, nothing was written.
            assert not cache[n][:, b, p0 + len(WIN_TOK[0]):].float().any()


def test_decoder_window_rows_equal_single_steps(setup):
    """A window scores each of its positions as the per-row steps would,
    one after the other (1e-5: the read spans the same masked cache)."""
    _, _, tpt, _, enc = setup
    win, _ = _window_port(tpt, enc, None)
    xkv = tdec.precompute_cross_kv(tpt, torch.from_numpy(enc), T_DEV)
    cache = tdec.init_kv_cache(T_DEV, 3, CTX)
    prompt = torch.tensor([[50258, 50259, 50359, 50363, 300, 301, 302]] * 3)
    _, cache = tdec.decoder_prefill(tpt, prompt, cache, xkv, T_DEV)
    tok, pos = torch.tensor(WIN_TOK), torch.tensor(WIN_POS)
    for i in range(tok.shape[1]):
        step, cache = tdec.decoder_step(tpt, tok[:, i], pos + i, cache, xkv, T_DEV)
        torch.testing.assert_close(step, win[:, i], rtol=1e-5, atol=1e-5)


def test_decoder_window_clamps_positions_past_the_table(setup):
    """A window that runs past ``n_text_ctx`` (a cache with slack rows):
    finite logits, and the positions inside the context score as a window
    that stops at its end."""
    _, _, tpt, _, enc = setup
    dims = dataclasses.replace(T_DEV, n_text_ctx=12)
    tpt = dict(tpt, decoder=dict(tpt["decoder"], pos_emb=tpt["decoder"]["pos_emb"][:12]))
    pos = [9, 10, 8]
    long, _ = _window_port(tpt, enc, None, ctx=12 + 4, pos=pos, dims=dims)
    assert torch.isfinite(long).all()
    short, _ = _window_port(tpt, enc, None, ctx=12 + 4, pos=pos, tok=[r[:2] for r in WIN_TOK], dims=dims)
    torch.testing.assert_close(long[:, :2], short, rtol=1e-5, atol=1e-5)


# --- speculative_greedy_decode ---------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 4])
def test_unrelated_draft_equal_to_jax(setup, k):
    ref, got, greedy = _both(setup, "other", 12, k)
    _assert_equal(ref, got, greedy)
    assert got[2]["accepted"] == 0 and got[2]["rounds"] == 11


def test_self_draft_equal_to_jax(setup):
    ref, got, greedy = _both(setup, "self", 12, 4)
    _assert_equal(ref, got, greedy)
    # 11 tokens after the first at 5 per round; the last round commits one.
    assert got[2] == {"rounds": 3, "drafted": 36, "accepted": 27}


def _rules_and_bias(bias_fill):
    v_jax = JaxVocab.synthetic(multilingual=True, num_languages=num_languages_for(DIMS.n_vocab))
    v_port = Vocab.synthetic(multilingual=True, num_languages=num_languages_for(DIMS.n_vocab))
    kw = dict(timestamps=True, suppress_blank=True, suppress_nonspeech=True, n_vocab=DIMS.n_vocab)
    bias = np.zeros(DIMS.n_vocab, np.float32)
    bias_fill(bias)
    return dict(rules=(jax_make_rules(v_jax, **kw), make_rules(v_port, **kw)),
                logit_bias=(jnp.asarray(bias), torch.from_numpy(bias)))


@pytest.mark.parametrize(
    "case",
    ["rules_and_bias", "eot_freeze"],
)
def test_rules_bias_and_eot_freeze_equal_to_jax(setup, case):
    if case == "rules_and_bias":
        kw = _rules_and_bias(lambda b: b.__setitem__(slice(100, 200), 3.0))
        ref, got, greedy = _both(setup, "other", 10, 3, **kw)
    else:
        bias = np.zeros(DIMS.n_vocab, np.float32)
        bias[EOT] = 2.6  # near the dev model's argmax margin: rows stop at different steps
        kw = dict(logit_bias=(jnp.asarray(bias), torch.from_numpy(bias)))
        ref, got, greedy = _both(setup, "other", 9, 4, **kw)
        lengths = got[1].tolist()
        assert len(set(lengths)) > 1, lengths
    _assert_equal(ref, got, greedy)


def test_no_speech_probs_equal_to_jax(setup):
    ns = (0, 50362)
    ref, got, greedy = _both(setup, "other", 6, 2, no_speech=(ns, ns))
    _assert_equal(ref, got, greedy)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5)


@pytest.mark.parametrize("draft", ["self", "other"])
def test_budget_filling_the_context_equals_greedy(setup, draft):
    """The repro where JAX's speculative decode leaves greedy: 444 new
    tokens after a 4-token prompt fill the 448-position context."""
    pt, pd, tpt, tpd, enc = setup
    enc2, prompt = enc[:2], PROMPT[:2]
    ref = jax_greedy(pt, jnp.asarray(enc2), jnp.asarray(prompt), DIMS, eot=EOT, max_new_tokens=444)
    got = speculative_greedy_decode(
        tpt, tpt if draft == "self" else tpd, torch.from_numpy(enc2), torch.from_numpy(prompt),
        T_DEV, T_DEV, eot=EOT, max_new_tokens=444, k_draft=4,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[0].shape == (2, DIMS.n_text_ctx)


def test_draft_of_a_narrower_vocabulary_equals_greedy(setup):
    """A target with large-v3's vocabulary (51866 ids) and a ``dev`` draft
    of 51865: the draft's ids clamp in its embedding and its logits widen
    to the target's rules; the tokens stay the target's greedy."""
    _, _, _, tpd, enc = setup
    dims_t = dataclasses.replace(DIMS, n_vocab=51866)
    pt = _tree(3, dims_t)
    prompt = np.array([[50258, 50259, 50360, 50364]] * 3, np.int32)
    v_jax = JaxVocab.synthetic(multilingual=True, num_languages=num_languages_for(51866))
    v_port = Vocab.synthetic(multilingual=True, num_languages=num_languages_for(51866))
    kw = dict(timestamps=True, suppress_blank=True, suppress_nonspeech=True, n_vocab=51866)
    ref = jax_greedy(pt, jnp.asarray(enc), jnp.asarray(prompt), dims_t, eot=EOT, max_new_tokens=10,
                     rules=jax_make_rules(v_jax, **kw))
    got = speculative_greedy_decode(
        _port(pt), tpd, torch.from_numpy(enc), torch.from_numpy(prompt),
        dataclasses.replace(T_DEV, n_vocab=51866), T_DEV, eot=EOT, max_new_tokens=10, k_draft=3,
        rules=make_rules(v_port, **kw),
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_foreign_draft_needs_its_encoder_output(setup):
    _, _, tpt, _, enc = setup
    tiny = T_DIMS["tiny"]
    with pytest.raises(ValueError, match="encoder geometry"):
        speculative_greedy_decode(tpt, tpt, torch.from_numpy(enc), torch.from_numpy(PROMPT), T_DEV,
                                  tiny, eot=EOT, max_new_tokens=4)
    with pytest.raises(ValueError, match="k_draft"):
        speculative_greedy_decode(tpt, tpt, torch.from_numpy(enc), torch.from_numpy(PROMPT), T_DEV,
                                  T_DEV, eot=EOT, max_new_tokens=4, k_draft=0)


# --- the engine -------------------------------------------------------------

CFG = dict(language="en", dtype="float32")


def _samples(seed, n=2):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n, 16_000))).astype(np.float32)


@pytest.fixture
def dev128(monkeypatch):
    """A ``dev`` target with 128 mel bins (the large-v3 + tiny pairing at
    dev scale), in both packages' tables."""
    dims = dataclasses.replace(MODEL_DIMS["dev"], n_mels=128)
    monkeypatch.setitem(jax_config.MODEL_DIMS, "dev128", dims)
    monkeypatch.setitem(torch_config.MODEL_DIMS, "dev128", dataclasses.replace(T_DEV, n_mels=128))
    return dims


@pytest.mark.parametrize(
    "target, engine, k, max_new",
    [("dev", "monolith", 3, 8), ("dev128", "monolith", 2, 6), ("dev", "encdec", 4, 7)],
)
def test_engine_with_a_draft_equal_to_jax(dev128, target, engine, k, max_new):
    tree_t = _tree(5, MODEL_DIMS[target] if target == "dev" else dev128)
    tree_d = _tree(6)
    samples = _samples(2)
    jax_type, port_type = (
        (JaxType.MONOLITH, EngineType.MONOLITH) if engine == "monolith"
        else (JaxType.ENCDEC, EngineType.ENCDEC)
    )
    over = dict(model=target, max_new_tokens=max_new, draft_model="dev", k_draft=k, **CFG)
    ref = jax_create_engine(jax_type, JaxConfig(**over), params=tree_t, draft_params=tree_d)
    ours = create_engine(port_type, EngineConfig(**over), params=_port(tree_t),
                         draft_params=_port(tree_d), device="cpu")
    plain = create_engine(port_type, EngineConfig(**dict(over, draft_model=None)),
                          params=_port(tree_t), device="cpu")
    assert ours._draft_share_encoder == (target == "dev")
    a, b, c = ref.transcribe_batch(samples), ours.transcribe_batch(samples), plain.transcribe_batch(samples)
    for r, g, p in zip(a, b, c):
        np.testing.assert_array_equal(g.tokens, r.tokens)
        np.testing.assert_array_equal(g.tokens, p.tokens)
        assert g.length == r.length and g.text == r.text and g.language == r.language
        assert g.avg_logprob is None and r.avg_logprob is None
    stats = ours.last_spec_stats
    assert stats["drafted"] == stats["rounds"] * k * 2 and stats["rounds"] >= 1


def test_random_draft_engine_is_the_targets_greedy():
    """``draft_params`` omitted: a random draft from a seeded generator,
    int8 like the target; tokens equal the plain int8 engine's."""
    cfg = dict(model="dev", max_new_tokens=6, quantization="int8", **CFG)
    plain = create_engine(EngineType.MONOLITH, EngineConfig(**cfg), seed=3, device="cpu")
    spec = create_engine(EngineType.MONOLITH, EngineConfig(draft_model="dev", **cfg), seed=3,
                         device="cpu")
    assert "w_q" in spec._draft_params["decoder"]["blocks"][0]["attn"]["q"]
    x = _samples(4)
    for a, b in zip(plain.transcribe_batch(x), spec.transcribe_batch(x)):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize(
    "override, match",
    [
        (dict(beam_size=3, draft_model="dev"), "greedy-only"),
        (dict(temperature=0.4, draft_model="dev"), "greedy-only"),
        (dict(fallback_temperatures=(0.2, 0.4), draft_model="dev"), "greedy-only"),
        (dict(model="dev128", draft_model="dev", engine="encdec"), "frontend geometry"),
    ],
)
def test_refusals_as_in_jax(dev128, override, match):
    override = dict(override)
    port_type = EngineType.ENCDEC if override.pop("engine", None) == "encdec" else EngineType.MONOLITH
    jax_type = JaxType.ENCDEC if port_type == EngineType.ENCDEC else JaxType.MONOLITH
    cfg = dict(dict(model="dev", language="en"), **override)
    with pytest.raises(ValueError, match=match):
        create_engine(port_type, EngineConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_create_engine(jax_type, JaxConfig(**cfg), seed=0)
