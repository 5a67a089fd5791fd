"""The port's BPE text encoder and ``initial_prompt`` text, against
whisper_tpu.

* ``encode_text`` on the JAX package's ``tests/test_bpe.py`` cases (a
  rank-ordered merge vocab and the synthetic byte vocab): the hand-computed
  ids, and the same ids as JAX's, with decode∘encode the identity;
* a hypothesis property: the port's scanner (``tokenizer/bpe.split``)
  splits arbitrary Unicode text exactly as JAX's ``regex`` pattern, and
  ``encode_text`` gives JAX's ids. Its alphabet leaves out code points the
  installed Python's ``unicodedata`` does not assign (category Cn; the
  ``regex`` package carries a newer Unicode database, whose later letters
  and numbers Python cannot know) and surrogates;
* ``import whisper_tpu_torch.tokenizer.bpe`` leaves ``regex`` out of
  ``sys.modules`` (subprocess);
* ``EngineConfig.initial_prompt`` through the engine, equal to JAX's: the
  prompt, tokens, text and language with language detection, timestamps
  and beam 3, the crop of a long prompt, and the refusal beside
  ``initial_prompt_tokens``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer import bpe as jax_bpe
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer import bpe
from whisper_tpu_torch.tokenizer.detokenize import decode_tokens
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MERGES = [b"th", b"he", b"the", b" t", b" the", b"er", b"ll", b"llo"]


def merged_vocab(cls=Vocab):
    """256 byte tokens (ids 0–255) + merges minted in rank order (tiktoken's
    id == rank)."""
    table = {i: bytes([i]) for i in range(256)}
    for j, m in enumerate(MERGES):
        table[256 + j] = m
    return cls(table, multilingual=False, n_vocab=256 + len(MERGES))


VOCABS = {
    "merged": (merged_vocab(), merged_vocab(JaxVocab)),
    "synthetic": (Vocab.synthetic(multilingual=False), JaxVocab.synthetic(multilingual=False)),
}


@pytest.mark.parametrize(
    "vocab, text, want",
    [
        ("merged", "the", [258]),  # th(256) before he(257), then the(258)
        ("merged", " the", [260]),
        ("merged", "the the", [258, 260]),
        ("merged", "thth", [256, 256]),  # leftmost tie first, never the middle "ht"
        ("merged", "her", [257, ord("r")]),  # he, then "her" absent
        ("merged", "llo", [263]),  # the whole-piece shortcut
        ("synthetic", "<|transcribe|>", None),  # a special's surface is text
        ("merged", "Mr. Quilter is the apostle of the middle classes.", None),
        ("merged", "  leading and   inner spaces kept ", None),
        ("merged", "tabs\tand\nnewlines", None),
        ("merged", "números, straße, 東京タワー, עברית", None),
        ("merged", "emoji 🎤🔊 and digits 12345", None),
        ("merged", "contractions: don't we'll I'm they've", None),
        ("merged", "", None),
        ("merged", "the quick brown fox <|weird|> \x00\xff", None),
        ("merged", "  　x\x1c\x1d y '' 's'S 12½ ⅓  \n", None),
    ],
)
def test_encode_text_equal_to_jax(vocab, text, want):
    ours, ref = VOCABS[vocab]
    ids = bpe.encode_text(ours, text)
    assert ids == jax_bpe.encode_text(ref, text)
    if want is not None:
        assert ids == want
    assert all(0 <= i < ours.specials.eot for i in ids)
    assert decode_tokens(ours, ids) == text


@pytest.mark.parametrize("prompt", ["the", "   the  ", " Quilter's  apostle\n"])
def test_initial_prompt_tokenization_equal_to_jax(prompt):
    ours, ref = VOCABS["merged"]
    got = bpe.encode_initial_prompt(ours, prompt)
    assert got == jax_bpe.encode_initial_prompt(ref, prompt)
    assert got == bpe.encode_text(ours, " " + prompt.strip())


ANY_TEXT = st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=60)
# Whitespace runs of every kind beside letters, numbers, apostrophes and
# the separators U+001C–U+001F that str.isspace counts and \s does not.
SPACEY_TEXT = st.text(st.sampled_from(" \t\n\x0b\x0c\r\x1c\x1f\x85\xa0 　aZé1½'s!-"), max_size=40)


@settings(max_examples=300, deadline=None)
@given(ANY_TEXT)
def test_scanner_splits_like_the_regex_on_any_text(text):
    assert list(bpe.split(text)) == [m.group() for m in jax_bpe._PAT.finditer(text)]


@settings(max_examples=300, deadline=None)
@given(SPACEY_TEXT)
def test_scanner_splits_like_the_regex_around_whitespace(text):
    assert list(bpe.split(text)) == [m.group() for m in jax_bpe._PAT.finditer(text)]
    ours, ref = VOCABS["merged"]
    assert bpe.encode_text(ours, text) == jax_bpe.encode_text(ref, text)


@settings(max_examples=100, deadline=None)
@given(ANY_TEXT)
def test_encode_text_equal_to_jax_on_any_text(text):
    ours, ref = VOCABS["merged"]
    assert bpe.encode_text(ours, text) == jax_bpe.encode_text(ref, text)


def test_import_leaves_regex_out():
    code = (
        "import sys\n"
        "import whisper_tpu_torch.tokenizer.bpe, whisper_tpu_torch.engine, whisper_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('regex', 'jax', 'triton', 'whisper_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


# --- initial_prompt text through the engine ---------------------------------

BASE = dict(model="dev", dtype="float32", max_new_tokens=6)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jax_init_params(JaxConfig(**BASE).dims(), jax.random.PRNGKey(21)))


def _audio(n=2):
    rng = np.random.default_rng(9)
    x = np.zeros((n, 48_000), np.float32)
    x[:, :40_000] = 0.1 * rng.standard_normal((n, 40_000))
    return x


@pytest.mark.parametrize(
    "override",
    [
        dict(initial_prompt="the quick brown fox", language=None),  # detection
        dict(initial_prompt="  Hello, world!  ", language="en", timestamps=True),
        dict(initial_prompt="don't stop", language=None, beam_size=3),
        dict(initial_prompt="x" * 200, language="de"),  # cropped to n_text_ctx // 2 - 1
    ],
)
def test_initial_prompt_through_the_engine_equal_to_jax(tree, override):
    cfg = dict(BASE, **override)
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax.tree.map(np.asarray, tree))
    ours = create_engine(EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(tree),
                         device="cpu")
    assert ours._prompt.tolist() == ref._prompt.tolist()
    assert int(ours._prompt[0]) == ours.vocab.specials.prev
    x = _audio()
    for a, b in zip(ref.transcribe_batch(x), ours.transcribe_batch(x)):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert (b.length, b.text, b.language) == (a.length, a.text, a.language)
        if cfg.get("timestamps"):
            assert [(s.start, s.end, s.text) for s in b.segments] == [
                (s.start, s.end, s.text) for s in a.segments
            ]


def test_text_and_ids_are_mutually_exclusive():
    cfg = EngineConfig(model="dev", initial_prompt="hi", initial_prompt_tokens=(1, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        create_engine(EngineType.MONOLITH, cfg, device="cpu")
