"""whisper_tpu_torch.decode.beam against whisper_tpu.decode.beam.

The selection pieces (topk_wide, select_candidates, _insert_finished) must
equal JAX's on inputs with forced ties: tie order is where torch.topk and
lax.top_k differ, so the port sorts stably. Then beam_decode end to end:
the JAX parameters are handed to the port (``params_from_jax``) and both
sides decode the same encoder output in float32 on the CPU at ``dev``
dims. JAX runs its eager step (``fused="off"``); the port runs each of its
three step modes ("off", "hybrid" through K2's plain version, "lineage").
Tokens and lengths must be EQUAL; normalised scores agree to rtol/atol
1e-4 (sums of f32 log-probabilities from logits that agree to ~1e-5). The
int8-weights + fp8-KV case must give equal tokens and lengths too.

JAX decodes are shared through module-scoped fixtures (one per case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.decode import beam as jbeam
from whisper_tpu.decode.logits import make_rules as jax_make_rules
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_tpu.tokenizer.vocab import Vocab as JaxVocab
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.decode import beam as tbeam
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.tokenizer.vocab import Vocab

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=48)
EOT, SOT, NOSPEECH = 50257, 50258, 50362
PROMPT = np.array([[SOT, 50259, 50359, 50363]] * 2, np.int32)
B, K, MAX_NEW = 2, 3, 13


# --- selection pieces, forced ties --------------------------------------


def test_topk_wide_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    jv, ji = jbeam.topk_wide(jnp.asarray(x), 4)
    tv, ti = tbeam.topk_wide(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_candidates_ties(seed):
    rng = np.random.default_rng(seed)
    k = 3
    # Scores from a small set, so many candidates tie; EOTs scattered.
    scores = rng.choice(np.array([-1.0, -2.0, -2.5, -3.0], np.float32), size=(4, k * (k + 1)))
    is_eot = rng.random((4, k * (k + 1))) < 0.3
    for i in range(4):  # the pool needs >= K non-EOT entries
        is_eot[i, :k] = False
        rng.shuffle(is_eot[i])
    ref = jbeam.select_candidates(jnp.asarray(scores), jnp.asarray(is_eot), k)
    ours = tbeam.select_candidates(torch.from_numpy(scores), torch.from_numpy(is_eot), k)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_insert_finished_ties():
    rng = np.random.default_rng(3)
    b, k, length = 3, 3, 7
    fin = dict(
        tokens=rng.integers(0, 9, (b, k, length)),
        scores=rng.choice(np.array([-1.0, -2.0], np.float32), (b, k)),
        lengths=rng.integers(1, length, (b, k)),
        valid=np.array([[True, False, False], [True, True, True], [False, False, False]]),
    )
    new = (
        rng.integers(0, 9, (b, k, length)),
        np.full((b, k), -1.0, np.float32),
        rng.integers(1, length, (b, k)),
        np.array([[True, True, False], [True, False, True], [False, True, True]]),
    )
    ref = jbeam._insert_finished(
        jbeam.FinishedSet(**{n: jnp.asarray(v) for n, v in fin.items()}),
        *(jnp.asarray(v) for v in new),
    )
    ours = tbeam._insert_finished(
        tbeam.FinishedSet(**{n: torch.from_numpy(v) for n, v in fin.items()}),
        *(torch.from_numpy(v) for v in new),
    )
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_lengths_of():
    t = np.array([[1, 2, 9, 9], [1, 2, 3, 4], [1, 2, 5, 9]])
    np.testing.assert_array_equal(
        tbeam._lengths_of(torch.from_numpy(t), 2, 9).numpy(),
        np.asarray(jbeam._lengths_of(jnp.asarray(t), 2, 9)),
    )


def test_resolve_fused():
    dims = T_DEV
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tbeam.resolve_fused("auto", dims, cpu, torch.float32) == "off"
    assert tbeam.resolve_fused("auto", dims, cuda, torch.float8_e4m3fn) == "hybrid"
    assert tbeam.resolve_fused(True, dims, cpu, torch.float32) == "hybrid"
    assert tbeam.resolve_fused(False, dims, cuda, torch.float32) == "off"
    for mode in tbeam.MODES:
        assert tbeam.resolve_fused(mode, dims, cpu, torch.float32) == mode
    odd = dataclasses.replace(dims, n_text_state=6, n_text_head=2)  # 6-byte fp8 positions
    assert tbeam.resolve_fused("auto", odd, cuda, torch.float8_e4m3fn) == "off"
    with pytest.raises(ValueError):
        tbeam.resolve_fused("hybrid", odd, cuda, torch.float8_e4m3fn)
    with pytest.raises(ValueError):
        tbeam.resolve_fused("merged", dims, cpu, torch.float32)


def test_reorder_cache_window_equals_full():
    rng = np.random.default_rng(4)
    cache = {n: torch.from_numpy(rng.standard_normal((2, 6, 9, 2, 4)).astype(np.float32)) for n in "kv"}
    idx = torch.tensor([2, 2, 0, 5, 1, 1])
    full = tbeam.reorder_cache(cache, idx, 6)
    win = tbeam.reorder_cache_window(cache, idx, 6, limit=5)
    for n in "kv":
        assert torch.equal(win[n][:, :, :5], full[n][:, :, :5])
        assert torch.equal(win[n][:, :, 5:], cache[n][:, :, 5:])


# --- beam_decode end to end ----------------------------------------------


@pytest.fixture(scope="module")
def setup():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(11)))
    enc = np.random.default_rng(12).standard_normal((B, 48, 64)).astype(np.float32)
    return tree, enc


def _rules():
    return (
        jax_make_rules(JaxVocab.synthetic(multilingual=True), n_vocab=DIMS.n_vocab),
        make_rules(Vocab.synthetic(multilingual=True), n_vocab=DIMS.n_vocab),
    )


def _bias(eot_bias):
    # An EOT bias brings EOTs into the candidate pools, so finished sets
    # fill during the decode (4.0: every set fills and the loop exits
    # early; 3.0: one sample finishes, the other is padded at the budget).
    bias = np.zeros(DIMS.n_vocab, np.float32)
    bias[EOT] = eot_bias
    bias[[11, 220, 464]] = [2.0, -3.0, 1.0]
    return bias


CASES = {
    "plain": {},
    "length_penalty+no_speech": dict(length_penalty=0.6, no_speech=(0, NOSPEECH), eot_bias=3.0),
    "rules+logit_bias": dict(rules=True, eot_bias=4.0),
}


def _kwargs(case, side):
    kw = dict(CASES[case])
    jr, tr = _rules()
    if kw.pop("rules", False):
        kw["rules"] = jr if side == "jax" else tr
    if "eot_bias" in kw:
        bias = _bias(kw.pop("eot_bias"))
        kw["logit_bias"] = jnp.asarray(bias) if side == "jax" else torch.from_numpy(bias)
    return kw


@pytest.fixture(scope="module")
def jax_out(setup):
    tree, enc = setup
    cache = {}

    def get(case, quantized=False):
        if (case, quantized) not in cache:
            params = jax.tree.map(jnp.asarray, jax_quantize_params(tree) if quantized else tree)
            out = jbeam.beam_decode(
                params, jnp.asarray(enc), jnp.asarray(PROMPT), DIMS, eot=EOT,
                max_new_tokens=MAX_NEW, beam_size=K, fused="off",
                kv_cache_dtype=jnp.float8_e4m3fn if quantized else None,
                **_kwargs(case, "jax"),
            )
            cache[(case, quantized)] = [np.asarray(x) for x in out]
        return cache[(case, quantized)]

    return get


def _port(setup, case, mode, quantized=False):
    tree, enc = setup
    if quantized:
        tree = jax.tree.map(np.asarray, jax_quantize_params(tree))
    params = params_from_jax(tree)
    out = tbeam.beam_decode(
        params, torch.from_numpy(enc), torch.from_numpy(PROMPT), T_DEV, eot=EOT,
        max_new_tokens=MAX_NEW, beam_size=K, fused=mode,
        kv_cache_dtype=torch.float8_e4m3fn if quantized else None,
        **_kwargs(case, "torch"),
    )
    return [x.numpy() for x in out]


@pytest.mark.parametrize("mode", tbeam.MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_decode_equal_to_jax(setup, jax_out, case, mode):
    ref = jax_out(case)
    before = tbeam.steps
    ours = _port(setup, case, mode)
    assert tbeam.steps > before
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4, atol=1e-4)
    if len(ref) == 4:
        np.testing.assert_allclose(ours[3], ref[3], rtol=1e-4, atol=1e-6)
    # The biased cases finish hypotheses before the budget.
    if "eot_bias" in CASES[case]:
        assert ours[1].min() < PROMPT.shape[1] + MAX_NEW


@pytest.mark.parametrize("mode", tbeam.MODES)
def test_beam_decode_int8_fp8_equal_to_jax(setup, jax_out, mode):
    ref = jax_out("rules+logit_bias", quantized=True)
    ours = _port(setup, "rules+logit_bias", mode, quantized=True)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4, atol=1e-4)
