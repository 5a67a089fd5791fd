"""Greedy autoregressive decoding.

Counterpart of ``whisper_tpu/decode/greedy.py``. The JAX loop is a
fixed-shape ``lax.while_loop`` over a cache that grows in segments
(``ctx_bucket``, a device for XLA's carry aliasing); here an eager Python
loop writes into one preallocated cache. The outputs are the same: a
token buffer prefilled with EOT, rows frozen at EOT once they emit it,
and an early exit once every row has finished.

Temperature sampling (``temperature=T``) picks ``argmax(logits + T * g)``
with Gumbel noise ``g = -log(-log(u))``: an exact sample from
``softmax(logits / T)``, and at ``T = 0`` exactly the greedy pick (the
noise is finite, so ``logits + 0 * g == logits`` bitwise). The uniform
``u`` is drawn on the decode's device from the caller's
``torch.Generator`` (:func:`draw_uniform`), one ``[B, n_vocab]`` draw per
step. A CUDA generator (Philox) and a CPU one (MT19937) give different
streams from the same seed, and neither is JAX's ``fold_in`` key stream:
sampled tokens agree across devices and with JAX only at T = 0 or with
the same injected noise.

On a tensor-parallel ``mesh`` every rank of a model group holds the same
all-reduced logits, so every rank picks the same tokens (and draws the
same noise: the engine seeds the generator by data index).
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
from whisper_tpu_torch.utils.profiling import annotate

# Decode steps run by greedy_decode in this process (the prefill not
# counted): with the collectives' counts it shows how many ran per step.
steps = 0


def all_on_host(flags: torch.Tensor) -> bool:
    """Whether every flag is set, read on the host: the decode loop's one
    wait for the card per step (the span ``decode.sync``)."""
    with annotate("decode.sync"):
        return bool(flags.all())


def argmax_last(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Argmax where ties pick the HIGHEST index (the reference scans with
    ``>=``, whisper.cpp:346-361); ``torch.argmax`` picks the lowest, so it
    runs on the flipped array."""
    n = logits.shape[dim]
    return (n - 1) - torch.argmax(torch.flip(logits, dims=(dim,)), dim=dim)


def draw_uniform(
    shape: Tuple[int, ...], pos: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """Uniform noise in ``[finfo(f32).tiny, 1)`` for the pick at position
    ``pos``, drawn on ``device`` from ``generator`` (the draws follow one
    another; ``pos`` names the step, as JAX folds it into its key). The
    clamp keeps ``-log(-log(u))`` finite where ``torch.rand`` returns 0, as
    JAX's ``minval`` does."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


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
    temperature: Optional[float] = None,  # ≥ 0; None: argmax, no noise drawn
    generator: Optional[torch.Generator] = None,  # on enc_out's device; with temperature
    return_logprobs: bool = False,
    no_speech: Optional[Tuple[int, int]] = None,  # (sot_index, nospeech_id)
    mesh=None,  # parallel.mesh.Mesh of this rank: its model axis cuts the heads
) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens [B, P + max_new_tokens], lengths [B]) — plus
    (sum_logprobs [B] f32,) when ``return_logprobs``, plus
    (no_speech_probs [B] f32,) when ``no_speech`` is given: the softmax
    probability of ``<|nospeech|>`` in the raw prefill logits at the SOT
    position.

    Output rows start with the prompt; unused tail positions hold ``eot``.
    ``lengths`` counts valid tokens including the terminating EOT.

    ``sum_logprobs`` adds ``log_softmax`` of the rule-constrained logits
    (before the noise) at each chosen token, the first pick and the
    terminating EOT included; rows stop adding once frozen (openai's
    ``GreedyDecoder.update`` bookkeeping for the fallback's logprob gate)."""
    global steps
    if temperature is not None and generator is None:
        raise ValueError("temperature sampling requires a torch.Generator")
    b, p_len = prompt.shape
    total_len = p_len + max_new_tokens
    if total_len > dims.n_text_ctx:
        raise ValueError(
            f"prompt({p_len}) + max_new({max_new_tokens}) exceeds n_text_ctx"
        )
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, enc_out, dims, kv_dtype=kv_cache_dtype, tp=mesh)

    def pick(logits: torch.Tensor, tokens: torch.Tensor, pos: int):
        """Constrained logits → (chosen token [B], its logprob [B] or None)."""
        if logit_bias is not None:
            logits = logits + logit_bias
        if rules is not None:
            logits = rules.apply(logits, tokens, pos, p_len)
        if temperature is not None:
            u = draw_uniform(tuple(logits.shape), pos, generator, device)
            gumbel = -torch.log(-torch.log(u))
            choice = argmax_last(logits.float() + float(temperature) * gumbel)
        else:
            choice = argmax_last(logits)
        if not return_logprobs:
            return choice, None
        lp = torch.log_softmax(logits.float(), dim=-1)
        return choice, lp.gather(-1, choice[:, None])[:, 0]

    with annotate("decode.loop", device=device) as loop:
        cache = init_kv_cache(
            dims, b, total_len, dtype=kv_cache_dtype or compute_dtype, device=device, tp=mesh
        )
        logits, cache = decoder_prefill(
            params, prompt, cache, cross_kv, dims, compute_dtype, tp=mesh
        )
        out_extra: Tuple[torch.Tensor, ...] = ()
        if no_speech is not None:
            sot_index, nospeech_id = no_speech
            probs_at_sot = torch.softmax(logits[:, sot_index, :].float(), dim=-1)
            out_extra = (probs_at_sot[:, nospeech_id],)

        tokens = torch.full((b, total_len), eot, dtype=torch.long, device=device)
        tokens[:, :p_len] = prompt
        first, first_lp = pick(logits[:, -1, :], tokens, p_len)
        tokens[:, p_len] = first
        finished = first == eot
        sum_lp = first_lp

        # Each step decides on the host whether to go on: one small device →
        # host read per token.
        pos = p_len + 1
        while pos < total_len and not all_on_host(finished):
            with annotate("decode.step"):
                logits, cache = decoder_step(
                    params, tokens[:, pos - 1], pos - 1, cache, cross_kv, dims, compute_dtype,
                    tp=mesh,
                )
                steps += 1
                nxt, lp = pick(logits, tokens, pos)
                if return_logprobs:  # frozen rows stop adding
                    sum_lp = sum_lp + torch.where(finished, 0.0, lp)
                nxt = torch.where(finished, eot, nxt)
                tokens[:, pos] = nxt
                finished = finished | (nxt == eot)
            pos += 1

        # Length = index of first EOT at/after the prompt, +1 to include it.
        is_eot = tokens[:, p_len:] == eot
        any_eot = is_eot.any(dim=1)
        first_eot = torch.argmax(is_eot.to(torch.int8), dim=1)
        lengths = torch.where(any_eot, p_len + first_eot + 1, total_len)
        if return_logprobs:
            out_extra = (sum_lp,) + out_extra
        loop.set(steps=pos - p_len - 1)
    return (tokens, lengths) + out_extra
