"""Text decoder with KV-cached self-attention and precomputed cross-attention.

Counterpart of the greedy-path parts of ``whisper_tpu/models/decoder.py``:
``init_kv_cache``, ``precompute_cross_kv``, ``_decoder_forward`` for a
shared (scalar) position, ``decoder_prefill`` and ``decoder_step``. Beam
widths, per-row positions and the merged-layout read are not ported yet.

Layouts are the JAX ones: self-attention cache ``{"k"/"v": [L, B, ctx, H,
Dh]}``, cross-attention K/V ``{"k"/"v": [L, B, H, Dh, n_audio_ctx]}``
(head-major, sequence-minor). Where JAX returns an updated copy of the
cache, the port writes the new rows into the cache in place and returns it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.params import Params

KVCache = Dict[str, torch.Tensor]

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free for
# fully-masked (not yet written) cache rows


def init_kv_cache(
    dims: ModelDims,
    batch: int,
    max_len: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> KVCache:
    max_len = max_len or dims.n_text_ctx
    h, dh = dims.n_text_head, dims.n_text_state // dims.n_text_head
    shape = (dims.n_text_layer, batch, max_len, h, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def precompute_cross_kv(params: Params, enc_out: torch.Tensor, dims: ModelDims) -> KVCache:
    """Cross-attention K/V over encoder states, computed once per utterance:
    [L, B, H, Dh, n_audio_ctx]. (The fp8 storage dtype of the JAX version
    is not ported yet.)"""
    n_head = dims.n_text_head
    ks, vs = [], []
    for bp in params["decoder"]["blocks"]:
        k = layers.split_heads(layers.linear(bp["cross"]["k"], enc_out), n_head)
        v = layers.split_heads(layers.linear(bp["cross"]["v"], enc_out), n_head)
        ks.append(k.permute(0, 2, 3, 1))  # [B, Tk, H, Dh] → [B, H, Dh, Tk]
        vs.append(v.permute(0, 2, 3, 1))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _decoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int64
    pos_offset: int,  # absolute position of tokens[:, 0], shared by all rows
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, KVCache]:
    """Shared body for prefill (T = prompt length) and step (T = 1).

    The self-attention read covers cache positions ``0 .. pos_offset+T-1``:
    the positions JAX leaves unmasked. The rows JAX reads past them carry
    mask -1e30 and weigh exactly 0 in f32, so the result is the same.
    Returns (logits [B, T, n_vocab] float32, cache)."""
    dec = params["decoder"]
    n_head = dims.n_text_head
    t = tokens.shape[1]
    end = pos_offset + t
    if end > cache["k"].shape[2]:
        raise ValueError(f"positions up to {end} exceed the cache length")

    x = layers.embed(dec["tok_emb"], tokens) + dec["pos_emb"][pos_offset:end]
    x = x.to(compute_dtype)

    # Causal mask over the read window: query at absolute position
    # pos_offset + i sees keys at positions <= that. A single new token sees
    # the whole window, so its mask is all zeros and is skipped.
    mask = None
    if t > 1:
        q_pos = pos_offset + torch.arange(t, device=x.device)[:, None]
        k_pos = torch.arange(end, device=x.device)[None, :]
        mask = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(compute_dtype)

    for layer, bp in enumerate(dec["blocks"]):
        # --- causal self-attention against the cache ---
        hn = layers.layer_norm(bp["ln1"], x)
        q = layers.split_heads(layers.linear(bp["attn"]["q"], hn), n_head)
        k_new = layers.split_heads(layers.linear(bp["attn"]["k"], hn), n_head)
        v_new = layers.split_heads(layers.linear(bp["attn"]["v"], hn), n_head)
        cache["k"][layer, :, pos_offset:end] = k_new
        cache["v"][layer, :, pos_offset:end] = v_new
        attn_out = layers.qkv_attention(
            q, cache["k"][layer, :, :end], cache["v"][layer, :, :end], mask
        )
        x = x + layers.linear(bp["attn"]["o"], layers.merge_heads(attn_out))

        # --- cross-attention over precomputed encoder K/V ---
        hn = layers.layer_norm(bp["ln2"], x)
        qx = layers.split_heads(layers.linear(bp["cross"]["q"], hn), n_head)
        cross_out = layers.cross_attention_T(qx, cross_kv["k"][layer], cross_kv["v"][layer])
        x = x + layers.linear(bp["cross"]["o"], layers.merge_heads(cross_out))

        # --- MLP ---
        x = x + layers.mlp(bp["mlp"], layers.layer_norm(bp["ln3"], x))

    x = layers.layer_norm(dec["ln"], x)
    return layers.unembed(dec["tok_emb"], x), cache


def decoder_prefill(
    params: Params,
    prompt: torch.Tensor,  # [B, P]
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the static prompt through the decoder once, filling cache[0:P].
    Returns (logits [B, P, V], cache)."""
    return _decoder_forward(params, prompt, 0, cache, cross_kv, dims, compute_dtype)


def decoder_step(
    params: Params,
    token: torch.Tensor,  # [B] — token at absolute position `pos`
    pos: int,
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step. Returns (logits [B, V], cache)."""
    logits, cache = _decoder_forward(
        params, token[:, None], int(pos), cache, cross_kv, dims, compute_dtype
    )
    return logits[:, 0, :], cache
