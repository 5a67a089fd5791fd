"""Audio encoder: conv stem → sinusoidal positions → N pre-LN attention blocks.

Counterpart of ``whisper_tpu/models/encoder.py``; the ``lax.scan`` over
stacked layers becomes a Python loop over the per-layer parameter dicts.
Under tensor parallelism (``tp``) each rank runs its ``n_audio_head / m``
heads and two all-reduces per layer (o and fc2): ``2 · n_audio_layer``
collectives per encode.
"""

from __future__ import annotations

import functools

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.params import Params, sinusoid_position_embedding
from whisper_tpu_torch.parallel import collectives


@functools.lru_cache(maxsize=8)
def _positions(length: int, channels: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The sinusoidal table on ``device`` in ``dtype``, uploaded once: a
    copy from pageable host memory waits for the card."""
    pos = sinusoid_position_embedding(length, channels)
    return torch.from_numpy(pos).to(device=device, dtype=dtype)


@collectives.stage("encode")
def encode(params: Params, mel: torch.Tensor, dims: ModelDims, tp=None) -> torch.Tensor:
    """[B, n_mels, n_frames] → [B, n_frames // 2, n_audio_state].

    Self-attention goes through K1 (``ops.attention.fused_self_attention``),
    on this rank's heads under ``tp``."""
    enc = params["encoder"]
    x = mel.transpose(-1, -2)  # [B, T, n_mels] — feature-last for conv
    x = layers.gelu(layers.conv1d(enc["conv1"], x, stride=1))
    x = layers.gelu(layers.conv1d(enc["conv2"], x, stride=2))  # T → T/2

    x = x + _positions(x.shape[1], dims.n_audio_state, x.device, x.dtype)

    n_head = collectives.local_heads(dims.n_audio_head, tp)
    for bp in enc["blocks"]:
        x = x + layers.mha_self(
            bp["attn"], layers.layer_norm(bp["ln1"], x), n_head, fused=True, tp=tp
        )
        x = x + layers.mlp(bp["mlp"], layers.layer_norm(bp["ln2"], x), tp=tp)
    return layers.layer_norm(enc["ln_post"], x)
