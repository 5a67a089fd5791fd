"""Parameter trees, random init, dtype policy, and the bridge from JAX.

Counterpart of ``whisper_tpu/models/params.py``. Parameters are a plain
nested dict of tensors with the same names as the JAX pytree, with two
differences of layout:

* the JAX tree stacks transformer blocks along a leading layer axis (for
  ``lax.scan``); here ``blocks`` is a list with one dict per layer, walked
  by a Python loop;
* conv weights are torch's ``[c_out, c_in, width]``; the JAX tree holds
  them as ``[width, c_in, c_out]`` (HIO).

Linear weights keep the JAX ``[d_in, d_out]`` layout (``layers.linear``
computes ``x @ w``), and ``decoder.tok_emb`` is both the embedding and the
unembedding table, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims

Params = Dict[str, Any]


def sinusoid_position_embedding(
    length: int, channels: int, max_timescale: float = 10_000.0
) -> np.ndarray:
    """Fixed sinusoidal table for the encoder, [length, channels]."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def init_params(
    dims: ModelDims,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Params:
    """Random-init parameter tree with the shapes and scales of the JAX
    ``_init_params_impl``. Draws on ``device`` from ``generator``, which
    must live on that device. The numbers differ from JAX's PRNG: tests
    that compare with JAX hand its weights over with :func:`params_from_jax`."""
    d_a, d_t = dims.n_audio_state, dims.n_text_state

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def dense(d_in, d_out, bias=True):
        p = {"w": normal((d_in, d_out), d_in**-0.5)}
        if bias:
            p["b"] = zeros(d_out)
        return p

    def ln(d):
        return {"g": torch.ones(d, dtype=dtype, device=device), "b": zeros(d)}

    def attn(d, kv_in):
        return {
            "q": dense(d, d),
            "k": dense(kv_in, d, bias=False),  # whisper: no K bias
            "v": dense(kv_in, d),
            "o": dense(d, d),
        }

    def mlp(d):
        return {"fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}

    def conv(width, c_in, c_out):
        return {
            "w": normal((c_out, c_in, width), (width * c_in) ** -0.5),
            "b": zeros(c_out),
        }

    encoder = {
        "conv1": conv(3, dims.n_mels, d_a),
        "conv2": conv(3, d_a, d_a),
        "blocks": [
            {"ln1": ln(d_a), "attn": attn(d_a, d_a), "ln2": ln(d_a), "mlp": mlp(d_a)}
            for _ in range(dims.n_audio_layer)
        ],
        "ln_post": ln(d_a),
    }
    decoder = {
        "tok_emb": normal((dims.n_vocab, d_t), d_t**-0.5),
        "pos_emb": normal((dims.n_text_ctx, d_t), 0.01),
        "blocks": [
            {
                "ln1": ln(d_t), "attn": attn(d_t, d_t), "ln2": ln(d_t),
                "cross": attn(d_t, d_a), "ln3": ln(d_t), "mlp": mlp(d_t),
            }
            for _ in range(dims.n_text_layer)
        ],
        "ln": ln(d_t),
    }
    return {"encoder": encoder, "decoder": decoder}


def _map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, name) for v in tree]
    return fn(name, tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Storage dtype policy (e.g. bf16 for serving). LayerNorm scales stay
    f32 — they're tiny and precision-critical."""
    return _map(lambda name, x: x.float() if name == "g" else x.to(dtype), params)


def to_device(params: Params, device: torch.device | str) -> Params:
    return _map(lambda _name, x: x.to(device), params)


def _tensor_from_numpy(x, copy: bool = True) -> torch.Tensor:
    """A numpy array → a CPU tensor of the same bits. ``copy``: the
    tensor gets memory of its own, and the caller's array stays its own;
    without it the tensor shares the array's memory (an array the caller
    hands over, in memory and writable)."""
    if copy:
        x = np.array(x)
    if x.dtype.name == "bfloat16" or x.dtype == np.dtype("V2"):
        # ml_dtypes bf16, or bf16 as an npz holds it: same bits as torch's
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    if x.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8: same bits as torch's
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(x)


def params_from_jax(tree: Params, device: torch.device | str = "cpu") -> Params:
    """JAX parameter pytree (leaves converted to numpy) → port parameters.

    Stacked ``blocks`` ([L, ...] leaves) become a list of per-layer dicts,
    conv weights go from HIO ``[width, c_in, c_out]`` to ``[c_out, c_in,
    width]``, everything else keeps its layout. Values and dtypes are kept
    bit for bit (bf16 and fp8 included). Int8 trees (``models/quantize.py``)
    convert the same way: ``w_q``/``w_s`` leaves (a conv ``w_q`` transposed
    like ``w``) and the ``tok_emb {"q", "s"}`` table."""

    def leaf(x):
        return _tensor_from_numpy(x).to(device)

    def unstack(blocks) -> list:
        n = len(next(iter(leaves(blocks))))
        return [_map(lambda _n, x: x[i], blocks) for i in range(n)]

    def convert(sub: dict) -> dict:
        out = {}
        for key, val in sub.items():
            if key == "blocks":
                out[key] = [convert(b) for b in unstack(val)]
            elif key in ("conv1", "conv2"):
                w = "w_q" if "w_q" in val else "w"
                out[key] = {
                    k: leaf(np.transpose(np.asarray(v), (2, 1, 0)) if k == w else v)
                    for k, v in val.items()
                }
            elif isinstance(val, dict):
                out[key] = convert(val)
            else:
                out[key] = leaf(val)
        return out

    return convert(tree)


def leaves(tree):
    """Every leaf of a parameter tree, in the tree's order."""
    if isinstance(tree, (dict, list)):
        for v in tree.values() if isinstance(tree, dict) else tree:
            yield from leaves(v)
    else:
        yield tree


def count_params(params: Params) -> int:
    """The number of parameters in a tree (every element of every leaf)."""
    return sum(x.numel() for x in leaves(params))
