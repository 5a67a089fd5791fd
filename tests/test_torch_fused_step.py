"""whisper_tpu_torch.ops.fused_step (K2's plain version) and the beam step
modes of whisper_tpu_torch.models.decoder, against whisper_tpu.

* ``permute_append``: the plain version against JAX's Pallas kernel in
  interpret mode, BITWISE (uint8) over rows [0, pos] of the write plane,
  for both parities, in f32 and fp8; the read plane and the other layers
  are untouched. (JAX copies whole rows; past ``pos`` the write plane is
  unspecified in both contracts.)
* ``decoder_step_fused`` ("hybrid") and ``decoder_step_lineage`` over three
  steps with real beam permutations (identity, swap, duplicate), against
  JAX ``reorder_cache`` ∘ ``decoder_step(beam_width=K)``: f32 logits to
  2e-4, bf16 KV to 5e-2 (the tolerances of JAX's own test of its fused
  step, tests/test_fused_step.py).
* Within the port, the hybrid step equals the eager step after a K4
  reorder BITWISE, in f32, bf16 and fp8: both run the same attention call
  on the same bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.decode.beam import reorder_cache as jax_reorder_cache
from whisper_tpu.models import decoder as jdec
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.ops.fused_step import permute_append as jax_permute_append
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.decode.beam import reorder_cache
from whisper_tpu_torch.models import decoder as tdec
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.ops import fused_step as tf

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=48)
B, BEAM, P_LEN, CTX = 2, 2, 3, 16
BK = B * BEAM
PERMS = [np.arange(BK), np.array([1, 0, 3, 3]), np.array([0, 0, 2, 3])]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# --- permute_append ------------------------------------------------------


@pytest.mark.parametrize(
    "np_dt, t_dt", [(np.float32, torch.float32), (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)]
)
@pytest.mark.parametrize("parity", [0, 1])
def test_permute_append_equals_jax_bitwise(np_dt, t_dt, parity):
    rng = np.random.default_rng(0)
    bk, ctx, hd, n_layer, layer, pos = 8, 32, 64, 3, 1, 9
    ck, cv = ((2 * rng.standard_normal((2, n_layer, bk, ctx, hd))).astype(np_dt) for _ in range(2))
    kn, vn = (rng.standard_normal((bk, hd)).astype(np.float32) for _ in range(2))
    idx = np.array([3, 3, 0, 5, 7, 1, 1, 4], np.int32)
    jk, jv = jax_permute_append(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(layer), jnp.int32(pos),
        jnp.int32(parity), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
    )
    tk, tv = (torch.from_numpy(x.view(np.uint8)).view(t_dt) for x in (ck, cv))
    before = tf.launches
    ok, ov = tf.permute_append(
        tk, tv, torch.from_numpy(idx), layer, pos, parity, torch.from_numpy(kn), torch.from_numpy(vn)
    )
    assert tf.launches == before and ok is tk and ov is tv  # plain version, in place
    w = 1 - parity
    for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
        ours, ref = _bytes(ours), _bytes(ref)
        np.testing.assert_array_equal(ours[w, layer, :, : pos + 1], ref[w, layer, :, : pos + 1])
        np.testing.assert_array_equal(ours[parity], _bytes(orig)[parity])
        np.testing.assert_array_equal(ours[w, :layer], _bytes(orig)[w, :layer])
        np.testing.assert_array_equal(ours[w, layer + 1 :], _bytes(orig)[w, layer + 1 :])


def test_permute_append_refusals():
    planes = torch.zeros(2, 2, 4, 8, 16)
    idx = torch.zeros(4, dtype=torch.int32)
    new = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        tf.permute_append(planes, planes.clone(), idx, 2, 1, 0, new, new)  # layer
    with pytest.raises(ValueError):
        tf.permute_append(planes, planes.clone(), idx, 0, 8, 0, new, new)  # pos
    with pytest.raises(ValueError):
        tf.permute_append(planes, planes.clone(), idx[:3], 0, 1, 0, new, new)
    with pytest.raises(ValueError):
        tf.permute_append(planes, planes.double(), idx, 0, 1, 0, new, new)
    assert tf.supported(64, 1) and tf.supported(384, 4) and not tf.supported(6, 1)


# --- decoder steps -------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(0)))
    enc = np.random.default_rng(5).standard_normal((B, 48, 64)).astype(np.float32)
    prompt = np.tile(np.arange(P_LEN, dtype=np.int32)[None], (B, 1))
    toks = np.random.default_rng(1).integers(0, 100, (len(PERMS), BK)).astype(np.int32)
    return tree, params_from_jax(tree), enc, prompt, toks


@pytest.fixture(scope="module")
def jax_logits(model):
    cache = {}

    def get(kv_dtype):
        if kv_dtype not in cache:
            cache[kv_dtype] = _jax_logits(model, kv_dtype)
        return cache[kv_dtype]

    return get


def _jax_logits(model, kv_dtype):
    tree, _, enc, prompt, toks = model
    params = jax.tree.map(jnp.asarray, tree)
    cross = jdec.precompute_cross_kv(params, jnp.asarray(enc), DIMS)
    cache = jdec.init_kv_cache(DIMS, B, CTX, dtype=kv_dtype)
    _, cache = jdec.decoder_prefill(params, jnp.asarray(prompt), cache, cross, DIMS)
    cache = {n: jnp.repeat(v, BEAM, axis=1) for n, v in cache.items()}
    pending, out = jnp.arange(BK, dtype=jnp.int32), []
    for step, perm in enumerate(PERMS):
        cache = jax_reorder_cache(cache, pending, BK)
        logits, cache = jdec.decoder_step(
            params, jnp.asarray(toks[step]), jnp.int32(P_LEN + step), cache, cross, DIMS,
            beam_width=BEAM,
        )
        out.append(np.asarray(logits))
        pending = jnp.asarray(perm, jnp.int32)
    return out


def _port_prefill(model, kv_dtype):
    _, params, enc, prompt, _ = model
    cross = tdec.precompute_cross_kv(params, torch.from_numpy(enc), T_DEV)
    cache = tdec.init_kv_cache(T_DEV, B, CTX, dtype=kv_dtype)
    _, cache = tdec.decoder_prefill(params, torch.from_numpy(prompt).long(), cache, cross, T_DEV)
    return params, cross, cache


def _port_logits(model, kv_dtype, mode):
    params, cross, cache_b = _port_prefill(model, kv_dtype)
    toks = torch.from_numpy(model[4]).long()
    pending = torch.arange(BK, dtype=torch.int32)
    parity = 0
    if mode == "hybrid":
        cache = tdec.plane_cache_from_prefill(cache_b, BEAM)
    else:
        cache = {n: v.repeat_interleave(BEAM, dim=1) for n, v in cache_b.items()}
        lineage = tdec.init_lineage(B, BEAM, CTX, P_LEN)
    out = []
    for step, perm in enumerate(PERMS):
        pos = P_LEN + step
        if mode == "hybrid":
            logits, cache = tdec.decoder_step_fused(
                params, toks[step], pos, cache, parity, pending, cross, T_DEV, beam_width=BEAM
            )
            parity = 1 - parity
        elif mode == "lineage":
            logits, cache, lineage = tdec.decoder_step_lineage(
                params, toks[step], pos, cache, lineage, cross, T_DEV, beam_width=BEAM
            )
            lineage = lineage[torch.from_numpy(perm)]
        else:  # "off": K4 reorder by the pending permutation, then the eager step
            cache = reorder_cache(cache, pending, BK)
            logits, cache = tdec.decoder_step(
                params, toks[step], pos, cache, cross, T_DEV, beam_width=BEAM
            )
        out.append(logits)
        pending = torch.from_numpy(perm).int()
    return out


@pytest.mark.parametrize("mode", ["hybrid", "lineage"])
@pytest.mark.parametrize(
    "jdt, tdt, tol",
    [(jnp.float32, torch.float32, 2e-4), (jnp.bfloat16, torch.bfloat16, 5e-2)],
)
def test_beam_step_modes_equal_to_jax(model, jax_logits, mode, jdt, tdt, tol):
    ref = jax_logits(jdt)
    ours = _port_logits(model, tdt, mode)
    for r, o in zip(ref, ours):
        np.testing.assert_allclose(o.numpy(), r, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_hybrid_equals_off_bitwise(model, dtype):
    off = _port_logits(model, dtype, "off")
    hybrid = _port_logits(model, dtype, "hybrid")
    for a, b in zip(off, hybrid):
        assert torch.equal(a, b)


def test_plane_cache_and_lineage_layout(model):
    _, _, cache = _port_prefill(model, torch.float32)
    planes = tdec.plane_cache_from_prefill(cache, BEAM)
    ref = jdec.plane_cache_from_prefill({n: jnp.asarray(v.numpy()) for n, v in cache.items()}, BEAM)
    for n in "kv":
        np.testing.assert_array_equal(planes[n].numpy(), np.asarray(ref[n]))
    np.testing.assert_array_equal(
        tdec.init_lineage(B, BEAM, CTX, P_LEN).numpy(), np.asarray(jdec.init_lineage(B, BEAM, CTX, P_LEN))
    )
