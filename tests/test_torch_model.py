"""whisper_tpu_torch.models against whisper_tpu.models: the weight bridge,
the encoder, and the decoder's cross-KV, prefill and step.

The JAX parameters (``init_params`` from a fixed key, leaves as numpy) are
handed to the port with ``params_from_jax``. Everything runs float32 on the
CPU; tolerances are stated per test and come from the order of f32 sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.models import decoder as jdec
from whisper_tpu.models.encoder import encode as jax_encode
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.models import decoder as tdec
from whisper_tpu_torch.models.encoder import encode
from whisper_tpu_torch.models.params import cast_params, init_params, params_from_jax

torch.set_num_threads(2)


def params_to_jax(params):
    """Port parameters → JAX-layout tree of numpy arrays (inverse of
    ``params_from_jax``). bf16 tensors come back as their uint16 bit
    patterns, since numpy has no bf16 of its own."""

    def leaf(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().copy()
        return x.numpy().copy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def convert(sub):
        out = {}
        for key, val in sub.items():
            if key == "blocks":
                out[key] = stack([convert(b) for b in val])
            elif key in ("conv1", "conv2"):
                out[key] = {
                    "w": np.transpose(leaf(val["w"]), (2, 1, 0)).copy(),
                    "b": leaf(val["b"]),
                }
            elif isinstance(val, dict):
                out[key] = convert(val)
            else:
                out[key] = leaf(val)
        return out

    return convert(params)


def _jax_np(dims, dtype=jnp.float32, seed=0):
    p = jax_init_params(dims, jax.random.PRNGKey(seed), dtype=dtype)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def dev_np():
    return _jax_np(MODEL_DIMS["dev"])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


class TestWeightBridge:
    def test_round_trip_bit_exact_f32(self, dev_np):
        back = dict(_leaves(params_to_jax(params_from_jax(dev_np))))
        orig = dict(_leaves(dev_np))
        assert back.keys() == orig.keys()
        for name, x in orig.items():
            assert back[name].dtype == x.dtype and back[name].shape == x.shape, name
            np.testing.assert_array_equal(back[name], x, err_msg=name)

    def test_bf16_bits_kept(self):
        tree = _jax_np(MODEL_DIMS["dev"], dtype=jnp.bfloat16, seed=1)
        port = params_from_jax(tree)
        assert port["decoder"]["tok_emb"].dtype == torch.bfloat16
        back = dict(_leaves(params_to_jax(port)))
        for name, x in _leaves(tree):
            np.testing.assert_array_equal(back[name], x.view(np.uint16), err_msg=name)

    def test_layouts(self, dev_np):
        port = params_from_jax(dev_np)
        dims = T_DIMS["dev"]
        assert len(port["encoder"]["blocks"]) == dims.n_audio_layer
        assert len(port["decoder"]["blocks"]) == dims.n_text_layer
        # conv: HIO [width, c_in, c_out] → torch [c_out, c_in, width]
        np.testing.assert_array_equal(
            port["encoder"]["conv1"]["w"].numpy(),
            np.transpose(dev_np["encoder"]["conv1"]["w"], (2, 1, 0)),
        )
        np.testing.assert_array_equal(
            port["decoder"]["blocks"][1]["cross"]["k"]["w"].numpy(),
            dev_np["decoder"]["blocks"]["cross"]["k"]["w"][1],
        )

    def test_random_init_same_tree_as_jax(self, dev_np):
        dims = T_DIMS["dev"]
        ours = params_to_jax(init_params(dims, torch.Generator().manual_seed(0)))
        a, b = dict(_leaves(ours)), dict(_leaves(dev_np))
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].shape == b[name].shape, name

    def test_cast_keeps_layernorm_scale_f32(self, dev_np):
        p = cast_params(params_from_jax(dev_np), torch.bfloat16)
        assert p["encoder"]["ln_post"]["g"].dtype == torch.float32
        assert p["encoder"]["ln_post"]["b"].dtype == torch.bfloat16
        assert p["decoder"]["blocks"][0]["mlp"]["fc1"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("model, batch", [("dev", 2), ("tiny", 1)])
def test_encode_matches_jax(model, batch):
    dims = MODEL_DIMS[model]
    tree = _jax_np(dims, seed=2)
    mel = np.random.default_rng(3).standard_normal((batch, dims.n_mels, 3000))
    mel = mel.astype(np.float32)
    ref = np.asarray(jax.jit(jax_encode, static_argnums=2)(tree, jnp.asarray(mel), dims))
    ours = encode(params_from_jax(tree), torch.from_numpy(mel), T_DIMS[model])
    assert ours.shape == ref.shape == (batch, 1500, dims.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


# Decoder at dev width with a short audio context (keeps the CPU run small).
DEC_DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=40)


@pytest.fixture(scope="module")
def dec_setup():
    tree = _jax_np(DEC_DIMS, seed=4)
    enc = np.random.default_rng(5).standard_normal((2, 40, 64)).astype(np.float32)
    port = params_from_jax(tree)
    tdims = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=40)
    return tree, enc, port, tdims


def test_cross_kv_matches_jax(dec_setup):
    tree, enc, port, tdims = dec_setup
    ref = jdec.precompute_cross_kv(tree, jnp.asarray(enc), DEC_DIMS)
    ours = tdec.precompute_cross_kv(port, torch.from_numpy(enc), tdims)
    for name in ("k", "v"):
        assert ours[name].shape == ref[name].shape == (2, 2, 2, 32, 40)
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]), atol=1e-5)


def test_prefill_and_steps_match_jax(dec_setup):
    """Logits of a 4-token prefill and three single-token steps: atol 1e-4
    on logits of order 1-10 (f32 sums in another order, compounded over two
    layers and three steps)."""
    tree, enc, port, tdims = dec_setup
    prompt = np.array([[50258, 50259, 50359, 50363], [50258, 50260, 50359, 50363]])
    steps = [np.array([11, 12]), np.array([400, 7]), np.array([3, 3])]

    xkv = jdec.precompute_cross_kv(tree, jnp.asarray(enc), DEC_DIMS)
    cache = jdec.init_kv_cache(DEC_DIMS, 2, 16)
    jl, cache = jdec.decoder_prefill(tree, jnp.asarray(prompt), cache, xkv, DEC_DIMS)
    ref = [np.asarray(jl)]
    for i, tok in enumerate(steps):
        jl, cache = jdec.decoder_step(tree, jnp.asarray(tok), 4 + i, cache, xkv, DEC_DIMS)
        ref.append(np.asarray(jl))

    txkv = tdec.precompute_cross_kv(port, torch.from_numpy(enc), tdims)
    tcache = tdec.init_kv_cache(tdims, 2, 16)
    tl, tcache = tdec.decoder_prefill(port, torch.from_numpy(prompt), tcache, txkv, tdims)
    ours = [tl.numpy()]
    for i, tok in enumerate(steps):
        tl, tcache = tdec.decoder_step(port, torch.from_numpy(tok), 4 + i, tcache, txkv, tdims)
        ours.append(tl.numpy())

    assert ours[0].shape == (2, 4, DEC_DIMS.n_vocab) and ours[1].shape == (2, DEC_DIMS.n_vocab)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["k"][:, :, :7].numpy(), np.asarray(cache["k"][:, :, :7]), atol=1e-5)


def test_step_past_cache_raises(dec_setup):
    _, enc, port, tdims = dec_setup
    txkv = tdec.precompute_cross_kv(port, torch.from_numpy(enc), tdims)
    cache = tdec.init_kv_cache(tdims, 2, 4)
    with pytest.raises(ValueError):
        tdec.decoder_step(port, torch.tensor([1, 2]), 4, cache, txkv, tdims)
