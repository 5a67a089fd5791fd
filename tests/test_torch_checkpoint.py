"""Checkpoints and conversion in the port, against whisper_tpu.

* npz files cross between the packages: one written by JAX's
  ``save_params`` loads in the port, and one written by the port loads in
  JAX, with equal parameters (f32, bf16, and int8 trees) and equal dims;
* ``from_openai_state_dict`` and ``from_hf_state_dict`` on state dicts the
  test builds from random weights: the port's parameters equal JAX's
  (through ``params_from_jax``) and the weights the dict was built from;
  ``load_checkpoint`` of an openai-format ``.pt`` in both packages;
* ``dims_from_openai`` and ``dims_from_hf_config`` equal JAX's;
* an Orbax directory is refused with a message, and a HuggingFace
  directory without ``transformers`` too.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS as J_DIMS
from whisper_tpu.models import convert as jconvert
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.models.quantize import quantize_params as jax_quantize
from whisper_tpu.utils import checkpoint as jckpt
from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.params import cast_params, init_params, leaves, params_from_jax
from whisper_tpu_torch.models.quantize import quantize_params
from whisper_tpu_torch.utils import checkpoint

torch.set_num_threads(2)
DIMS = MODEL_DIMS["dev"]


def assert_same(a, b, path="params"):
    """Two port parameter trees: the same structure, dtypes and bytes."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)), path


def _port_params(kind):
    params = init_params(DIMS, torch.Generator().manual_seed(3))
    if kind == "bfloat16":
        return cast_params(params, torch.bfloat16)
    if kind == "int8":
        return quantize_params(params)
    return params


def _jax_tree(kind):
    tree = jax_init_params(J_DIMS["dev"], jax.random.PRNGKey(4))
    if kind == "bfloat16":
        tree = jax.tree.map(lambda x: x.astype(jax.numpy.bfloat16), tree)
    if kind == "int8":
        tree = jax_quantize(tree)
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_npz_written_by_jax_loads_in_the_port(tmp_path, kind):
    tree = _jax_tree(kind)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params(path, tree, J_DIMS["dev"])
    params, dims = checkpoint.load_params(path)
    assert dims == DIMS
    assert_same(params, params_from_jax(tree))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_npz_written_by_the_port_loads_in_jax(tmp_path, kind):
    params = _port_params(kind)
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, params, DIMS)
    tree, dims = jckpt.load_params(path)
    assert dataclasses.asdict(dims) == dataclasses.asdict(DIMS)
    if kind == "bfloat16":  # JAX's np.load gives bf16 as the opaque 2-byte type
        assert all(x.dtype in (np.dtype("V2"), np.float32) for x in jax.tree.leaves(tree))
    assert_same(params_from_jax(tree), params)
    again, _ = checkpoint.load_params(path)
    assert_same(again, params)


# --- state dicts ------------------------------------------------------------


# Names of the two dialects: (block prefix, self-attention LN, attention,
# cross LN, cross attention, MLP LN of a decoder block, MLP LN of an encoder
# block, q/k/v/o, fc1/fc2, final LN, token and position tables).
OPENAI = dict(
    enc="encoder.blocks", dec="decoder.blocks", ln1="attn_ln", attn="attn", ln2="cross_attn_ln",
    cross="cross_attn", ln3="mlp_ln", enc_ln2="mlp_ln", qkvo=("query", "key", "value", "out"),
    fc=("mlp.0", "mlp.2"), conv="encoder", enc_ln="encoder.ln_post", dec_ln="decoder.ln",
    tok="decoder.token_embedding.weight", pos="decoder.positional_embedding",
)
HF = dict(
    enc="model.encoder.layers", dec="model.decoder.layers", ln1="self_attn_layer_norm",
    attn="self_attn", ln2="encoder_attn_layer_norm", cross="encoder_attn", ln3="final_layer_norm",
    enc_ln2="final_layer_norm", qkvo=("q_proj", "k_proj", "v_proj", "out_proj"), fc=("fc1", "fc2"),
    conv="model.encoder", enc_ln="model.encoder.layer_norm", dec_ln="model.decoder.layer_norm",
    tok="model.decoder.embed_tokens.weight", pos="model.decoder.embed_positions.weight",
)


def _state_dict(params, n):
    """A state dict of dialect ``n`` (OPENAI or HF) holding the port
    ``params``: torch's Linear ``[out, in]``, conv ``[c_out, c_in, w]``."""
    sd = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = p["w"].t().contiguous()
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["g"], p["b"]

    def attn(prefix, p):
        for ours, theirs in zip("qkvo", n["qkvo"]):
            lin(f"{prefix}.{theirs}", p[ours])

    def mlp(prefix, p):
        lin(f"{prefix}.{n['fc'][0]}", p["fc1"])
        lin(f"{prefix}.{n['fc'][1]}", p["fc2"])

    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        sd[f"{n['conv']}.{c}.weight"], sd[f"{n['conv']}.{c}.bias"] = enc[c]["w"], enc[c]["b"]
    for i, bp in enumerate(enc["blocks"]):
        pre = f"{n['enc']}.{i}"
        ln(f"{pre}.{n['ln1']}", bp["ln1"])
        attn(f"{pre}.{n['attn']}", bp["attn"])
        ln(f"{pre}.{n['enc_ln2']}", bp["ln2"])
        mlp(pre, bp["mlp"])
    ln(n["enc_ln"], enc["ln_post"])
    sd[n["tok"]], sd[n["pos"]] = dec["tok_emb"], dec["pos_emb"]
    for i, bp in enumerate(dec["blocks"]):
        pre = f"{n['dec']}.{i}"
        ln(f"{pre}.{n['ln1']}", bp["ln1"])
        attn(f"{pre}.{n['attn']}", bp["attn"])
        ln(f"{pre}.{n['ln2']}", bp["ln2"])
        attn(f"{pre}.{n['cross']}", bp["cross"])
        ln(f"{pre}.{n['ln3']}", bp["ln3"])
        mlp(pre, bp["mlp"])
    ln(n["dec_ln"], dec["ln"])
    return sd


def _hf_config(dims):
    return types.SimpleNamespace(
        num_mel_bins=dims.n_mels, max_source_positions=dims.n_audio_ctx, d_model=dims.n_audio_state,
        encoder_attention_heads=dims.n_audio_head, encoder_layers=dims.n_audio_layer,
        vocab_size=dims.n_vocab, max_target_positions=dims.n_text_ctx,
        decoder_attention_heads=dims.n_text_head, decoder_layers=dims.n_text_layer,
    )


@pytest.mark.parametrize("dialect", ["openai", "hf"])
def test_state_dict_conversion_equal_to_jax(dialect):
    params = _port_params("float32")
    if dialect == "openai":
        sd = _state_dict(params, OPENAI)
        ours = convert.from_openai_state_dict(sd, DIMS)
        ref = jconvert.from_openai_state_dict(sd, J_DIMS["dev"])
    else:
        sd = _state_dict(params, HF)
        ours = convert.from_hf_state_dict(sd, DIMS)
        ref = jconvert.from_hf_state_dict(sd, J_DIMS["dev"])
    assert_same(ours, params)
    assert_same(params_from_jax(jax.tree.map(np.asarray, ref)), params)
    if dialect == "openai":  # the port's inverse builds the same dict
        ours_sd = convert.openai_state_dict(params)
        assert sorted(ours_sd) == sorted(sd)
        for k in sd:
            assert torch.equal(ours_sd[k], sd[k]), k


def test_dims_from_headers_equal_to_jax():
    for name in ("dev", "tiny", "large-v3", "distil-large-v3"):
        d = MODEL_DIMS[name]
        header = {k: getattr(d, k) for k in (
            "n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
            "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")}
        assert convert.dims_from_openai(header) == d
        assert dataclasses.asdict(jconvert.dims_from_openai(header)) == dataclasses.asdict(d)
        assert convert.dims_from_hf_config(_hf_config(d)) == d
        assert dataclasses.asdict(jconvert.dims_from_hf_config(_hf_config(d))) == dataclasses.asdict(d)


def test_load_checkpoint_of_an_openai_pt_equal_to_jax(tmp_path):
    params = _port_params("float32")
    path = str(tmp_path / "model.pt")
    torch.save({"dims": dataclasses.asdict(DIMS), "model_state_dict": _state_dict(params, OPENAI)}, path)
    ours, dims = convert.load_checkpoint(path)
    ref, jdims = jconvert.load_checkpoint(path)
    assert dims == DIMS and dataclasses.asdict(jdims) == dataclasses.asdict(DIMS)
    assert_same(ours, params)
    assert_same(params_from_jax(jax.tree.map(np.asarray, ref)), params)
    assert all(x.device.type == "cpu" for x in leaves(ours))


def test_orbax_and_hf_directories_refused(tmp_path, monkeypatch):
    orbax = tmp_path / "orbax"
    os.makedirs(orbax / "params")
    (orbax / "dims.json").write_text(json.dumps(dataclasses.asdict(DIMS)))
    with pytest.raises(ValueError, match="Orbax"):
        convert.load_checkpoint(str(orbax))
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.load_params(str(orbax))
    monkeypatch.setitem(sys.modules, "transformers", None)  # as if not installed
    with pytest.raises(RuntimeError, match="transformers"):
        convert.load_checkpoint(str(tmp_path))


def test_hf_directory_equal_to_jax(tmp_path):
    """A saved ``WhisperForConditionalGeneration`` (random, small) through
    both packages' ``load_checkpoint``; skips without ``transformers``."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=1000, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=30, max_target_positions=32, pad_token_id=998, bos_token_id=997,
        eos_token_id=999, decoder_start_token_id=996,
    )
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(cfg).save_pretrained(str(tmp_path))
    ours, dims = convert.load_checkpoint(str(tmp_path))
    ref, jdims = jconvert.load_checkpoint(str(tmp_path))
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    assert (dims.n_text_layer, dims.n_vocab, dims.n_audio_ctx) == (2, 1000, 30)
    assert_same(ours, params_from_jax(jax.tree.map(np.asarray, ref)))
