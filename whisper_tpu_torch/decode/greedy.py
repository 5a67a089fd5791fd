"""Greedy autoregressive decoding.

Counterpart of ``whisper_tpu/decode/greedy.py``. The JAX loop is a
fixed-shape ``lax.while_loop`` over a cache that grows in segments
(``ctx_bucket``, a device for XLA's carry aliasing); here an eager Python
loop writes into one preallocated cache. The outputs are the same: a
token buffer prefilled with EOT, rows frozen at EOT once they emit it,
and an early exit once every row has finished.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.decode.logits import LogitRules
from whisper_tpu_torch.models.decoder import (
    KVCache,
    decoder_prefill,
    decoder_step,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.models.params import Params


def argmax_last(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Argmax where ties pick the HIGHEST index (the reference scans with
    ``>=``, whisper.cpp:346-361); ``torch.argmax`` picks the lowest, so it
    runs on the flipped array."""
    n = logits.shape[dim]
    return (n - 1) - torch.argmax(torch.flip(logits, dims=(dim,)), dim=dim)


def greedy_decode(
    params: Params,
    enc_out: torch.Tensor,  # [B, n_audio_ctx, d]
    prompt: torch.Tensor,  # [B, P] int
    dims: ModelDims,
    eot: int,
    max_new_tokens: int,
    logit_bias: Optional[torch.Tensor] = None,  # additive [n_vocab] f32
    rules: Optional[LogitRules] = None,
    compute_dtype: torch.dtype = torch.float32,
    cross_kv: Optional[KVCache] = None,  # shared with language detection
    kv_cache_dtype: Optional[torch.dtype] = None,  # cache storage (None: compute dtype)
    temperature=None,
    no_speech: Optional[Tuple[int, int]] = None,  # (sot_index, nospeech_id)
) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens [B, P + max_new_tokens], lengths [B]) — plus
    (no_speech_probs [B] f32,) when ``no_speech`` is given: the softmax
    probability of ``<|nospeech|>`` in the raw prefill logits at the SOT
    position.

    Output rows start with the prompt; unused tail positions hold ``eot``.
    ``lengths`` counts valid tokens including the terminating EOT."""
    if temperature is not None:
        raise NotImplementedError("temperature sampling is not ported yet")
    b, p_len = prompt.shape
    total_len = p_len + max_new_tokens
    if total_len > dims.n_text_ctx:
        raise ValueError(
            f"prompt({p_len}) + max_new({max_new_tokens}) exceeds n_text_ctx"
        )
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, enc_out, dims, kv_dtype=kv_cache_dtype)
    cache = init_kv_cache(
        dims, b, total_len, dtype=kv_cache_dtype or compute_dtype, device=device
    )

    def pick(logits: torch.Tensor, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        if logit_bias is not None:
            logits = logits + logit_bias
        if rules is not None:
            logits = rules.apply(logits, tokens, pos, p_len)
        return argmax_last(logits)

    logits, cache = decoder_prefill(params, prompt, cache, cross_kv, dims, compute_dtype)
    out_extra: Tuple[torch.Tensor, ...] = ()
    if no_speech is not None:
        sot_index, nospeech_id = no_speech
        probs_at_sot = torch.softmax(logits[:, sot_index, :].float(), dim=-1)
        out_extra = (probs_at_sot[:, nospeech_id],)

    tokens = torch.full((b, total_len), eot, dtype=torch.long, device=device)
    tokens[:, :p_len] = prompt
    first = pick(logits[:, -1, :], tokens, p_len)
    tokens[:, p_len] = first
    finished = first == eot

    # Each step decides on the host whether to go on: one small device →
    # host read per token.
    pos = p_len + 1
    while pos < total_len and not bool(finished.all()):
        logits, cache = decoder_step(
            params, tokens[:, pos - 1], pos - 1, cache, cross_kv, dims, compute_dtype
        )
        nxt = pick(logits, tokens, pos)
        nxt = torch.where(finished, eot, nxt)
        tokens[:, pos] = nxt
        finished = finished | (nxt == eot)
        pos += 1

    # Length = index of first EOT at/after the prompt, +1 to include it.
    is_eot = tokens[:, p_len:] == eot
    any_eot = is_eot.any(dim=1)
    first_eot = torch.argmax(is_eot.to(torch.int8), dim=1)
    lengths = torch.where(any_eot, p_len + first_eot + 1, total_len)
    return (tokens, lengths) + out_extra
