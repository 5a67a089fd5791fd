"""whisper_tpu_torch.models.layers against whisper_tpu.models.layers.

Same inputs (numpy, from a seed) through the JAX function and its port,
on the CPU. float32: atol 1e-5 (only the order of sums differs). bfloat16:
both sides see the same bf16-rounded inputs; the port's bf16 matmul rounds
its product to bf16 before the f32 bias add (JAX rounds once, after it), so
outputs may differ by about one bf16 ulp of their scale: |a - b| <=
2^-7 * max|ref| + 2^-7 * |ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import layers as jl
from whisper_tpu_torch.models import layers as tl

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]
ULP = 2.0**-7


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _j(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(ours, ref, dtype, atol32=1e-5):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=atol32)
    else:
        np.testing.assert_allclose(
            ours, ref, rtol=ULP, atol=ULP * float(np.abs(ref).max())
        )


def _dense(rng, d_in, d_out, bias=True):
    p = {"w": _rand(rng, d_in, d_out, scale=d_in**-0.5)}
    if bias:
        p["b"] = _rand(rng, d_out, scale=0.1)
    return p


def _pj(p, dtype):
    return {k: (_pj(v, dtype) if isinstance(v, dict) else _j(v, dtype)) for k, v in p.items()}


def _pt(p, dtype):
    return {k: (_pt(v, dtype) if isinstance(v, dict) else _t(v, dtype)) for k, v in p.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
def test_linear(dtype, bias):
    rng = np.random.default_rng(0)
    p = _dense(rng, 64, 96, bias)
    x = _rand(rng, 2, 7, 64)
    _close(tl.linear(_pt(p, dtype), _t(x, dtype)), jl.linear(_pj(p, dtype), _j(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    rng = np.random.default_rng(1)
    p = {"g": 1.0 + _rand(rng, 64, scale=0.1), "b": _rand(rng, 64, scale=0.1)}
    x = 3.0 + _rand(rng, 2, 5, 64, scale=2.0)  # offset mean: population var matters
    _close(
        tl.layer_norm(_pt(p, dtype), _t(x, dtype)),
        jl.layer_norm(_pj(p, dtype), _j(x, dtype)),
        dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu(dtype):
    x = _rand(np.random.default_rng(2), 4, 33, scale=3.0)
    _close(tl.gelu(_t(x, dtype)), jl.gelu(_j(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d(dtype, stride):
    rng = np.random.default_rng(3)
    w_hio = _rand(rng, 3, 16, 32, scale=(3 * 16) ** -0.5)
    b = _rand(rng, 32, scale=0.1)
    x = _rand(rng, 2, 20, 16)
    ref = jl.conv1d({"w": _j(w_hio, dtype), "b": _j(b, dtype)}, _j(x, dtype), stride=stride)
    w_torch = np.transpose(w_hio, (2, 1, 0))  # HIO → [c_out, c_in, width]
    ours = tl.conv1d({"w": _t(w_torch, dtype), "b": _t(b, dtype)}, _t(x, dtype), stride=stride)
    _close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(dtype):
    rng = np.random.default_rng(4)
    table = _rand(rng, 50, 16, scale=0.25)
    tokens = rng.integers(0, 50, size=(2, 5))
    _close(
        tl.embed(_t(table, dtype), torch.from_numpy(tokens)),
        jl.embed(_j(table, dtype), jnp.asarray(tokens)),
        dtype,
    )
    x = _rand(rng, 2, 3, 16)
    ours = tl.unembed(_t(table, dtype), _t(x, dtype))
    assert ours.dtype == torch.float32
    _close(ours, jl.unembed(_j(table, dtype), _j(x, dtype)), "float32", atol32=1e-5)


def test_split_merge_heads():
    x = _rand(np.random.default_rng(5), 2, 7, 12)
    s = tl.split_heads(_t(x, "float32"), 3)
    np.testing.assert_array_equal(_np(s), _np(jl.split_heads(_j(x, "float32"), 3)))
    np.testing.assert_array_equal(_np(tl.merge_heads(s)), x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_qkv_attention(dtype, masked):
    rng = np.random.default_rng(6)
    q, k, v = (_rand(rng, 2, 6, 2, 16) for _ in range(3))
    mask = None
    if masked:  # causal, as the decoder's prefill builds it
        pos = np.arange(6)
        mask = np.where(pos[None, :] <= pos[:, None], 0.0, -1e30).astype(np.float32)
    ours = tl.qkv_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), None if mask is None else _t(mask, dtype)
    )
    ref = jl.qkv_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), None if mask is None else _j(mask, dtype)
    )
    _close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_T(dtype):
    rng = np.random.default_rng(7)
    q = _rand(rng, 2, 3, 2, 16)
    kT, vT = _rand(rng, 2, 2, 16, 30), _rand(rng, 2, 2, 16, 30)
    _close(
        tl.cross_attention_T(_t(q, dtype), _t(kT, dtype), _t(vT, dtype)),
        jl.cross_attention_T(_j(q, dtype), _j(kT, dtype), _j(vT, dtype)),
        dtype,
    )


def _attn_params(rng, d):
    return {
        "q": _dense(rng, d, d), "k": _dense(rng, d, d, bias=False),
        "v": _dense(rng, d, d), "o": _dense(rng, d, d),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [False, True])
def test_mha_self(dtype, fused):
    rng = np.random.default_rng(8)
    p = _attn_params(rng, 64)
    x = _rand(rng, 2, 9, 64)
    _close(
        tl.mha_self(_pt(p, dtype), _t(x, dtype), 2, fused=fused),
        jl.mha_self(_pj(p, dtype), _j(x, dtype), 2, fused=False),
        dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    rng = np.random.default_rng(9)
    p = {"fc1": _dense(rng, 32, 128), "fc2": _dense(rng, 128, 32)}
    x = _rand(rng, 2, 5, 32)
    _close(tl.mlp(_pt(p, dtype), _t(x, dtype)), jl.mlp(_pj(p, dtype), _j(x, dtype)), dtype)

