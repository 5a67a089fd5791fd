"""Per-row decoder positions (the slot pool's step) against whisper_tpu.

``decoder_step`` with a ``[B]`` position vector and ``LogitRules.apply``
with per-row positions, on the same inputs and weights (``params_from_jax``)
as JAX's, at ``dev`` width in float32 on the CPU:

* logits within 1e-4 of JAX's (f32 sums in another order, over two layers
  and several steps), with an f32 and an fp8 cache; the cache rows each
  step writes within 1e-5 (f32) or byte-equal (fp8, where rounding the same
  f32 value gives the same byte);
* the rules' logits EXACTLY equal to JAX's, timestamps on and off;
* the shared ``int`` position form unchanged: per-row positions that are
  all equal give bitwise the int form's logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.decode.logits import make_rules as jax_make_rules
from whisper_tpu.models import decoder as jdec
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.models import decoder as tdec
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=40)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=40)
EOT, SOT = 50257, 50258
BEG = 50364  # <|0.00|> in the 99-language multilingual layout
CTX = 12
PROMPT = np.array([[SOT, SOT + 1, 50359, 50363]] * 3)


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(11)))
    enc = np.random.default_rng(12).standard_normal((3, 40, 64)).astype(np.float32)
    return tree, params_from_jax(tree), enc


# Three rows at their own depths, as slots of a pool: each list is one
# step's positions (an inactive slot repeats its position).
POSITIONS = [[4, 4, 4], [5, 4, 6], [6, 5, 7], [7, 5, 8]]
TOKENS = [[11, 12, 13], [400, 7, 9], [3, 3, 501], [60, 2, 77]]


def _run_jax(tree, enc, kv_dtype):
    xkv = jdec.precompute_cross_kv(tree, jnp.asarray(enc), DIMS)
    cache = jdec.init_kv_cache(DIMS, 3, CTX, dtype=kv_dtype or jnp.float32)
    _, cache = jdec.decoder_prefill(tree, jnp.asarray(PROMPT), cache, xkv, DIMS)
    out = []
    for pos, tok in zip(POSITIONS, TOKENS):
        logits, cache = jdec.decoder_step(
            tree, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), cache, xkv, DIMS
        )
        out.append(np.asarray(logits))
    return out, {n: np.asarray(cache[n]) for n in ("k", "v")}


def _run_port(port, enc, kv_dtype):
    xkv = tdec.precompute_cross_kv(port, torch.from_numpy(enc), T_DEV)
    cache = tdec.init_kv_cache(T_DEV, 3, CTX, dtype=kv_dtype or torch.float32)
    _, cache = tdec.decoder_prefill(port, torch.from_numpy(PROMPT), cache, xkv, T_DEV)
    out = []
    for pos, tok in zip(POSITIONS, TOKENS):
        logits, cache = tdec.decoder_step(port, torch.tensor(tok), torch.tensor(pos), cache, xkv, T_DEV)
        out.append(logits.numpy())
    return out, cache


@pytest.mark.parametrize("kv", ["float32", "float8_e4m3fn"])
def test_decoder_step_rows_equal_to_jax(setup, kv):
    tree, port, enc = setup
    jax_kv = None if kv == "float32" else jnp.float8_e4m3fn
    torch_kv = None if kv == "float32" else torch.float8_e4m3fn
    ref, ref_cache = _run_jax(tree, enc, jax_kv)
    ours, cache = _run_port(port, enc, torch_kv)
    for o, r in zip(ours, ref):
        assert o.shape == (3, DIMS.n_vocab)
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
    # Every position any step wrote, row by row.
    written = sorted({(b, p) for pos in POSITIONS for b, p in enumerate(pos)})
    for n in ("k", "v"):
        for b, p in written:
            got = cache[n][:, b, p]
            want = ref_cache[n][:, b, p]
            if kv == "float32":
                np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
            else:
                np.testing.assert_array_equal(
                    got.view(torch.uint8).numpy(), want.view(np.uint8)
                )
        # Positions no step wrote stay as the prefill left them (zeros past it).
        assert not cache[n][:, 0, 8:].float().any()


def test_rows_at_one_depth_equal_the_int_form(setup):
    """All rows at one position: the per-row step and the shared-position
    step give the same logits (the per-row read spans the whole cache, its
    extra keys masked to weight 0)."""
    _, port, enc = setup
    xkv = tdec.precompute_cross_kv(port, torch.from_numpy(enc), T_DEV)
    caches = []
    for _ in range(2):
        cache = tdec.init_kv_cache(T_DEV, 3, CTX)
        _, cache = tdec.decoder_prefill(port, torch.from_numpy(PROMPT), cache, xkv, T_DEV)
        caches.append(cache)
    tok = torch.tensor([5, 6, 7])
    a, _ = tdec.decoder_step(port, tok, 4, caches[0], xkv, T_DEV)
    b, _ = tdec.decoder_step(port, tok, torch.tensor([4, 4, 4]), caches[1], xkv, T_DEV)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    for n in ("k", "v"):
        torch.testing.assert_close(caches[1][n], caches[0][n], rtol=0, atol=0)


def test_rows_refuse_windows_and_beams(setup):
    """Per-row positions decode one hypothesis per row: a beam width is
    refused for a window (T > 1, the speculative verify pass, which is
    ported since ``decoder_window``) as for a step."""
    _, port, enc = setup
    xkv = tdec.precompute_cross_kv(port, torch.from_numpy(enc), T_DEV)
    cache = tdec.init_kv_cache(T_DEV, 3, CTX)
    with pytest.raises(ValueError):
        tdec._decoder_forward(port, torch.ones((3, 2), dtype=torch.long), torch.tensor([1, 2, 3]),
                              cache, xkv, T_DEV, beam_width=3)
    with pytest.raises(ValueError):
        tdec.decoder_step(port, torch.ones(3, dtype=torch.long), torch.tensor([1, 2, 3]), cache, xkv,
                          T_DEV, beam_width=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_scatter_rows_writes_each_row_at_its_position(dtype):
    dt = getattr(torch, dtype)
    dst = torch.zeros((4, 6, 2, 8), dtype=dt)
    new = torch.randn((4, 2, 8), generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([0, 5, 2, 2])
    tdec.scatter_rows(dst, pos, new)
    want = torch.zeros((4, 6, 2, 8), dtype=dt)
    for b in range(4):
        want[b, pos[b]] = new[b].to(dt)
    assert torch.equal(dst.view(torch.uint8), want.view(torch.uint8))


# --- LogitRules with per-row positions ----------------------------------------


def _rules_pair(timestamps):
    jv = JaxVocab.synthetic(multilingual=True)
    tv = Vocab.synthetic(multilingual=True)
    return (
        jax_make_rules(jv, timestamps=timestamps, n_vocab=DIMS.n_vocab),
        make_rules(tv, timestamps=timestamps, n_vocab=DIMS.n_vocab),
    )


# One row per timestamp-grammar case (the generated tokens after the
# 4-token prompt), each at its own position.
ROWS = [
    ([], 4),  # first sampled position: a timestamp (or EOT) must come
    ([BEG + 3], 5),  # after a text-less <ts>: text or another <ts>
    ([BEG + 3, 17], 6),  # after text: anything but an earlier timestamp
    ([BEG + 3, 17, BEG + 9], 7),  # text <ts>: no text, the pair closes
    ([BEG + 3, 17, BEG + 9, BEG + 9], 8),  # <ts> <ts>: no timestamp
    ([BEG + 3, 17, 18, 19, 20], 9),
    ([BEG + 3, 17, 18, 19, 20, 21, 22, 23], 12),  # at the buffer's end
]


def _rules_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((len(ROWS), DIMS.n_vocab)).astype(np.float32)
    logits[1, BEG:] += 4.0  # row 1: timestamp mass beats text → forced timestamp
    tokens = np.full((len(ROWS), 12), EOT, np.int32)
    tokens[:, :4] = [SOT, SOT + 1, 50359, 50363]
    for i, (row, _) in enumerate(ROWS):
        tokens[i, 4 : 4 + len(row)] = row
    pos = np.array([p for _, p in ROWS], np.int32)
    return logits, tokens, pos


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_rules_rows_equal_to_jax(timestamps, seed):
    jr, tr = _rules_pair(timestamps)
    logits, tokens, pos = _rules_inputs(seed)
    ref = np.asarray(jr.apply(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(pos), 4))
    ours = tr.apply(torch.from_numpy(logits), torch.from_numpy(tokens).long(), torch.from_numpy(pos).long(), 4)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("p", [4, 5, 7, 9])
def test_rules_rows_at_one_depth_equal_the_int_form(timestamps, p):
    _, tr = _rules_pair(timestamps)
    logits, tokens, _ = _rules_inputs(3)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tokens).long()
    shared = tr.apply(lt, tt, p, 4)
    rows = tr.apply(lt, tt, torch.full((len(ROWS),), p), 4)
    assert torch.equal(rows, shared)


def test_fp8_bytes_agree_between_numpy_and_torch():
    """The fp8 cache comparison above is byte for byte: ml_dtypes (JAX) and
    torch round in-range f32 values to the same e4m3 bytes."""
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 8
    a = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    b = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(a, b)
