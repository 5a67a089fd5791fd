"""whisper_tpu_torch.models.quantize and the int8 / fp8 branches of
whisper_tpu_torch.models.layers, against whisper_tpu.

* ``quantize_params`` of the same float weights equals JAX's BITWISE
  (``w_q``, ``w_s``, ``tok_emb`` ``q``/``s``), through ``params_from_jax``,
  which also shows that the bridge takes a quantized tree.
* The int8 ``linear``, ``conv1d``, ``embed`` and ``unembed`` agree with
  JAX's in f32 to 1e-5 (same products, another summation order).
* fp8 e4m3fn: in-range f32 values cast to the same bytes on both sides
  (round to nearest even). Out of range the two differ, as recorded below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.models import layers as jl
from whisper_tpu.models import quantize as jq
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.models import layers as tl
from whisper_tpu_torch.models import quantize as tq
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)


@pytest.fixture(scope="module")
def trees():
    tree = jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(4)))
    jq_tree = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, tree)))
    return tree, jq_tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_quantize_params_bitwise(trees):
    tree, jq_tree = trees
    ours = dict(_flat(tq.quantize_params(params_from_jax(tree))))
    ref = dict(_flat(params_from_jax(jq_tree)))
    assert ours.keys() == ref.keys()
    assert any(k.endswith("/w_q") for k in ours) and "/decoder/tok_emb/q" in ours
    for name, r in ref.items():
        o = ours[name]
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o.contiguous().view(torch.uint8), r.view(torch.uint8)), name


def test_dequantize_and_helpers(trees):
    tree, jq_tree = trees
    q = params_from_jax(jq_tree)
    assert tq.is_quantized(q) and not tq.is_quantized(params_from_jax(tree))
    assert tq.param_bytes(q) == jq.param_bytes(jax.tree.map(jnp.asarray, jq_tree))
    ours = dict(_flat(tq.dequantize_params(q)))
    ref = dict(_flat(params_from_jax(jax.tree.map(np.asarray, jq.dequantize_params(jq_tree)))))
    assert ours.keys() == ref.keys()
    for name, r in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), r.numpy(), err_msg=name)


def _q_linear(rng, d_in, d_out, bias=True):
    w = rng.standard_normal((d_in, d_out)).astype(np.float32) * d_in**-0.5
    q, s = jq.absmax_quantize(w, (0,))
    p = {"w_q": q, "w_s": s}
    if bias:
        p["b"] = rng.standard_normal(d_out).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear(bias):
    rng = np.random.default_rng(1)
    p = _q_linear(rng, 64, 96, bias)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ref = jl.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ours = tl.linear({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_int8_conv1d():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 16, 32)).astype(np.float32) * 0.2  # JAX HIO
    q, s = jq.absmax_quantize(w, (0, 1))
    b = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal((2, 20, 16)).astype(np.float32)
    ref = jl.conv1d({"w_q": jnp.asarray(q), "w_s": jnp.asarray(s), "b": jnp.asarray(b)}, jnp.asarray(x), stride=2)
    tree = params_from_jax({"conv1": {"w_q": q, "w_s": s, "b": b}})  # HIO → [c_out, c_in, width]
    ours = tl.conv1d(tree["conv1"], torch.from_numpy(x), stride=2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_int8_embed_unembed():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((300, 64)).astype(np.float32) * 0.125
    q, s = jq.absmax_quantize(table, (1,))
    tokens = rng.integers(0, 300, (2, 7))
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jt = {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    tt = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    np.testing.assert_array_equal(
        tl.embed(tt, torch.from_numpy(tokens)).numpy(), np.asarray(jl.embed(jt, jnp.asarray(tokens)))
    )
    np.testing.assert_allclose(
        tl.unembed(tt, torch.from_numpy(x)).numpy(), np.asarray(jl.unembed(jt, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5,
    )


def test_absmax_quantize_bitwise_on_ties():
    # Values on exact .5 steps of the scale: round half to even on both sides.
    w = (np.arange(-254, 255, dtype=np.float32) / 2.0).reshape(-1, 1) * np.array([[1.0, 0.25]], np.float32)
    jq_, js = jq.absmax_quantize(w, (0,))
    tq_, ts = tq.absmax_quantize(torch.from_numpy(w), (0,))
    np.testing.assert_array_equal(tq_.numpy(), jq_)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_fp8_cast_bytes():
    inside = np.array([0.0, 1.0, 1.0625, 1.1875, -3.3, 2.0**-9 * 1.5, 447.0, 448.0, 464.0], np.float32)
    ours = torch.from_numpy(inside).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    ref = np.asarray(jnp.asarray(inside).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, inside.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
    # Out of e4m3 range (|x| >= 480 rounds past 448): torch saturates to
    # ±448 (0x7e / 0xfe), JAX and ml_dtypes give NaN (0x7f / 0xff). K/V
    # activations stay far inside the range.
    outside = np.array([480.0, 1e4, -1e4], np.float32)
    assert torch.from_numpy(outside).to(torch.float8_e4m3fn).view(torch.uint8).tolist() == [0x7E, 0x7E, 0xFE]
    assert np.asarray(jnp.asarray(outside).astype(jnp.float8_e4m3fn)).view(np.uint8).tolist() == [0x7F, 0x7F, 0xFF]


def test_fp8_attention_upcast():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(ml_dtypes.float8_e4m3fn) for _ in range(2))
    kT, vT = (rng.standard_normal((2, 2, 16, 11)).astype(ml_dtypes.float8_e4m3fn) for _ in range(2))
    t8 = lambda a: torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)  # noqa: E731
    ours = tl.qkv_attention(torch.from_numpy(q), t8(k), t8(v))
    ref = jl.qkv_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    ours = tl.cross_attention_T(torch.from_numpy(q), t8(kT), t8(vT))
    ref = jl.cross_attention_T(jnp.asarray(q), jnp.asarray(kT), jnp.asarray(vT))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
