"""whisper_tpu_torch.decode against whisper_tpu.decode: greedy decode, the
suppress rules, the prompt, and language detection.

The JAX parameters are handed to the port (``params_from_jax``) and both
sides decode the same encoder output in float32 on the CPU. Token ids and
lengths must be EQUAL; the no-speech probability agrees to atol 1e-6 (a
softmax entry of f32 logits that agree to ~1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.decode import greedy as jgreedy
from whisper_tpu.decode import language as jlang
from whisper_tpu.decode.logits import make_rules as jax_make_rules
from whisper_tpu.decode.prompt import build_prompt as jax_build_prompt
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.decode import language as tlang
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.decode.prompt import build_prompt
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=48)
EOT, SOT = 50257, 50258


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(7)))
    enc = np.random.default_rng(8).standard_normal((3, 48, 64)).astype(np.float32)
    return tree, params_from_jax(tree), enc


def _rules_pair(timestamps=False):
    jv = JaxVocab.synthetic(multilingual=True)
    tv = Vocab.synthetic(multilingual=True)
    return (
        jax_make_rules(jv, timestamps=timestamps, n_vocab=DIMS.n_vocab),
        make_rules(tv, timestamps=timestamps, n_vocab=DIMS.n_vocab),
    )


@pytest.mark.parametrize("timestamps", [False, True])
def test_rule_tables_equal(timestamps):
    jr, tr = _rules_pair(timestamps)
    np.testing.assert_array_equal(tr.static_bias, jr.static_bias)
    np.testing.assert_array_equal(tr.blank_bias, jr.blank_bias)
    assert (tr.eot, tr.sot, tr.not_, tr.beg) == (jr.eot, jr.sot, jr.not_, jr.beg)


def test_rules_apply_equal():
    jr, tr = _rules_pair()
    logits = np.random.default_rng(9).standard_normal((2, DIMS.n_vocab)).astype(np.float32)
    tokens = np.zeros((2, 8), np.int32)
    for pos in (4, 5):
        ref = np.asarray(jr.apply(jnp.asarray(logits), jnp.asarray(tokens), pos, 4))
        ours = tr.apply(torch.from_numpy(logits), torch.from_numpy(tokens), pos, 4)
        np.testing.assert_array_equal(ours.numpy(), ref)


BEG = 50364  # <|0.00|> in the 99-language multilingual layout


@pytest.mark.parametrize(
    "row, pos",
    [
        ([], 4),  # first sampled position: a timestamp (or EOT) must come
        ([BEG + 3], 5),  # after text-less <ts>: text or another <ts>
        ([BEG + 3, 17], 6),  # after text: anything but an earlier timestamp
        ([BEG + 3, 17, BEG + 9], 7),  # text <ts>: no text, pair closes
        ([BEG + 3, 17, BEG + 9, BEG + 9], 8),  # <ts> <ts>: no timestamp
        ([BEG + 3, 17, 18, 19, 20], 9),
    ],
)
def test_timestamp_rules_apply_equal(row, pos):
    jr, tr = _rules_pair(timestamps=True)
    rng = np.random.default_rng(len(row))
    logits = rng.standard_normal((3, DIMS.n_vocab)).astype(np.float32)
    logits[1, BEG:] += 4.0  # row 1: timestamp mass beats text → forced timestamp
    tokens = np.full((3, 12), EOT, np.int32)
    tokens[:, :4] = [SOT, SOT + 1, 50359, 50364 - 1]
    tokens[:, 4 : 4 + len(row)] = row
    ref = np.asarray(jr.apply(jnp.asarray(logits), jnp.asarray(tokens), pos, 4))
    ours = tr.apply(torch.from_numpy(logits), torch.from_numpy(tokens).long(), pos, 4)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize(
    "kw",
    [
        dict(multilingual=True, language="de"),
        dict(multilingual=True, language="fr", task="translate"),
        dict(multilingual=False),
        dict(multilingual=True, language="en", reference_quirks=True),
        dict(multilingual=True, language="en", prefix_tokens=[5, 6, 7]),
    ],
)
def test_build_prompt_equal(kw):
    assert build_prompt(**kw) == jax_build_prompt(**kw)


def test_argmax_last_takes_highest_tie():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 1.0, 5.0]])
    assert tgreedy.argmax_last(x).tolist() == [2, 3]
    np.testing.assert_array_equal(
        tgreedy.argmax_last(x).numpy(), np.asarray(jgreedy.argmax_last(jnp.asarray(x.numpy())))
    )


def _decode_both(setup, prompt, max_new, rules=True, bias=None, no_speech=None):
    tree, port, enc = setup
    jr, tr = _rules_pair(rules == "timestamps") if rules else (None, None)
    jout = jgreedy.greedy_decode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(enc), jnp.asarray(prompt), DIMS, EOT, max_new,
        logit_bias=None if bias is None else jnp.asarray(bias), rules=jr,
        no_speech=no_speech,
    )
    tout = tgreedy.greedy_decode(
        port, torch.from_numpy(enc), torch.from_numpy(prompt), T_DEV, EOT, max_new,
        logit_bias=None if bias is None else torch.from_numpy(bias), rules=tr,
        no_speech=no_speech,
    )
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def _prompt(lang_ids):
    return np.array([[SOT, SOT + 1 + lid, 50359, 50363] for lid in lang_ids], np.int32)


@pytest.mark.parametrize("rules", [True, False, "timestamps"])
def test_greedy_tokens_equal(setup, rules):
    prompt = _prompt([0, 2, 6])
    if rules == "timestamps":
        prompt = prompt[:, :3]  # no <|notimestamps|>
    ref, ours = _decode_both(setup, prompt, 12, rules=rules)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])


def test_greedy_logit_bias_and_early_eot(setup):
    # A large EOT bias ends rows early: exercises the EOT freeze, the tail
    # fill and the lengths.
    bias = np.zeros(DIMS.n_vocab, np.float32)
    bias[EOT] = 12.0
    bias[1234] = 6.0
    ref, ours = _decode_both(setup, _prompt([0, 1, 2]), 10, bias=bias)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert (ours[1] < 14).any()  # some row stopped before the budget


def test_greedy_no_speech_probs(setup):
    ref, ours = _decode_both(setup, _prompt([3, 3, 4]), 6, no_speech=(0, 50362))
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[2].shape == (3,)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4, atol=1e-6)


def test_greedy_budget_check(setup):
    _, port, enc = setup
    with pytest.raises(ValueError):
        tgreedy.greedy_decode(
            port, torch.from_numpy(enc), torch.from_numpy(_prompt([0, 0, 0])), T_DEV,
            EOT, DIMS.n_text_ctx,
        )


def test_detect_language_equal(setup):
    tree, port, enc = setup
    jt, jp = jlang.detect_language_tokens(tree, jnp.asarray(enc), DIMS, SOT, return_probs=True)
    tt, tp = tlang.detect_language_tokens(port, torch.from_numpy(enc), T_DEV, SOT, return_probs=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    assert [tlang.lang_token_to_code(t, SOT) for t in tt.tolist()] == [
        jlang.lang_token_to_code(t, SOT) for t in np.asarray(jt).tolist()
    ]


def test_detect_language_lowest_index_on_tie(monkeypatch):
    # jnp.argmax (and torch.argmax) take the LOWEST index on a tie; the
    # greedy pick takes the highest. Detection keeps the lowest.
    logits = torch.zeros(1, 1, T_DEV.n_vocab)
    logits[0, 0, SOT + 1 + 5] = logits[0, 0, SOT + 1 + 9] = 1.0
    monkeypatch.setattr(tlang, "decoder_prefill", lambda *a, **k: (logits, None))
    tok = tlang.detect_language_tokens(
        {}, torch.zeros(1, 4, 64), T_DEV, SOT, cross_kv={"k": None, "v": None}
    )
    assert tok.tolist() == [SOT + 1 + 5]
