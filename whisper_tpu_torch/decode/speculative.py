"""Speculative greedy decoding: a small draft model proposes ``k`` tokens
per round, and the target scores the whole window in one forward.

Counterpart of ``whisper_tpu/decode/speculative.py``, with its signature,
its return ``(tokens, lengths, stats[, no_speech_probs])`` and its stats.
The output equals the target's own :func:`decode.greedy.greedy_decode`
for any draft: a draft token is kept only where it equals the target's
rule-constrained ``argmax_last`` at that position, and the first mismatch
is replaced by the target's own pick, so every emitted token is the one
greedy would have picked. A draft of a different vocabulary width (a
``tiny`` draft under a ``large-v3`` target, one language token short)
proposes through its own embedding with the ids clamped to its table, and
its logits are fitted to the target's width (missing ids at -1e30), so the
target's rules and bias apply to them; only acceptance suffers.

JAX's ``lax.while_loop`` becomes a host loop over rounds. Each round runs
``k + 1`` per-row draft steps (the last only writes d_k's own K/V row: on a
full-accept round the next window starts past it), one target
:func:`models.decoder.decoder_window` over ``[prev, d_1 .. d_k]`` at
per-row positions, and the accept/commit bookkeeping on the device:
leading matches, the EOT clamp, the budget clamp, frozen rows. The one
host read per round is the continue test, as greedy reads one value per
step.

The token buffer and both caches hold ``l_buf = min(total + k, n_text_ctx +
k)`` positions: a window that starts at the last budget position writes up
to ``k`` slack rows past it, never emitted. Their positional embedding is
clamped to the table's last row (``decoder._rows_forward``). JAX's
per-row gather (``jnp.take``) fills NaN there instead of clipping, and a
masked NaN row still poisons its window (0 × NaN), so its speculative
tokens leave greedy's where a budget fills the context; the port follows
greedy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.decode.greedy import argmax_last
from whisper_tpu_torch.decode.logits import NEG_INF, LogitRules
from whisper_tpu_torch.models.decoder import (
    KVCache,
    decoder_prefill,
    decoder_step,
    decoder_window,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.models.params import Params


def _fit_vocab(logits: torch.Tensor, n_vocab: int) -> torch.Tensor:
    """Draft logits [B, V_d] → [B, n_vocab]: ids the draft lacks at -1e30,
    ids past ``n_vocab`` dropped."""
    v = logits.shape[-1]
    if v == n_vocab:
        return logits
    if v > n_vocab:
        return logits[..., :n_vocab]
    return torch.nn.functional.pad(logits, (0, n_vocab - v), value=NEG_INF)


def speculative_greedy_decode(
    params_t: Params,
    params_d: Params,
    enc_out_t: torch.Tensor,  # [B, n_audio_ctx, d_target]
    prompt: torch.Tensor,  # [B, P] int
    dims_t: ModelDims,
    dims_d: ModelDims,
    eot: int,
    max_new_tokens: int,
    k_draft: int = 4,
    enc_out_d: Optional[torch.Tensor] = None,  # None: share the target's
    # encoder output (Distil-Whisper drafts reuse the teacher's encoder)
    logit_bias: Optional[torch.Tensor] = None,  # additive [n_vocab] f32
    rules: Optional[LogitRules] = None,
    compute_dtype: torch.dtype = torch.float32,
    kv_cache_dtype: Optional[torch.dtype] = None,
    no_speech: Optional[Tuple[int, int]] = None,  # (sot_index, nospeech_id)
    cross_kv_t: Optional[KVCache] = None,  # the target's, when the caller
    # already computed it (language detection shares it)
    mesh=None,  # parallel.mesh.Mesh of this rank: its model axis cuts the
    # target's heads; the draft stays whole on every rank, as in JAX
) -> Tuple:
    """Returns (tokens [B, P + max_new], lengths [B], stats), plus
    (no_speech_probs [B],) when ``no_speech`` is given. ``stats`` is
    ``{"rounds", "drafted", "accepted"}`` as ints: ``accepted / drafted``
    is the acceptance rate (``drafted = rounds · k · B``: frozen rows still
    draft). Tokens and lengths equal ``greedy_decode(params_t, ...)``'s."""
    b, p_len = prompt.shape
    k = int(k_draft)
    if k < 1:
        raise ValueError("k_draft must be >= 1")
    total_len = p_len + max_new_tokens
    if total_len > dims_t.n_text_ctx:
        raise ValueError("prompt + max_new_tokens exceeds n_text_ctx")
    l_buf = min(total_len + k, dims_t.n_text_ctx + k)
    device = enc_out_t.device
    prompt = prompt.to(device=device, dtype=torch.long)
    n_vocab = dims_t.n_vocab

    if enc_out_d is None:
        if dims_d.n_audio_state != dims_t.n_audio_state:
            raise ValueError(
                "draft encoder geometry differs from the target's; pass "
                "enc_out_d from the draft's own encoder"
            )
        enc_out_d = enc_out_t.to(compute_dtype)
    cross_t = cross_kv_t
    if cross_t is None:
        cross_t = precompute_cross_kv(
            params_t, enc_out_t, dims_t, kv_dtype=kv_cache_dtype, tp=mesh
        )
    cross_d = precompute_cross_kv(params_d, enc_out_d, dims_d, kv_dtype=kv_cache_dtype)

    def draft_ids(tokens: torch.Tensor) -> torch.Tensor:
        # JAX's tok_emb[tokens] clamps an id past the draft's table.
        return tokens.clamp(max=dims_d.n_vocab - 1)

    def constrain(logits, tokens, pos):
        """Rule-constrained f32 logits, in greedy_decode's order."""
        logits = logits.float()
        if logit_bias is not None:
            logits = logits + logit_bias
        if rules is not None:
            logits = rules.apply(logits, tokens, pos, p_len)
        return logits

    # --- prefill both models; the first token comes from the target ---
    kv_dt = kv_cache_dtype or compute_dtype
    cache_t = init_kv_cache(dims_t, b, l_buf, dtype=kv_dt, device=device, tp=mesh)
    logits_t, cache_t = decoder_prefill(
        params_t, prompt, cache_t, cross_t, dims_t, compute_dtype, tp=mesh
    )
    cache_d = init_kv_cache(dims_d, b, l_buf, dtype=kv_dt, device=device)
    _, cache_d = decoder_prefill(params_d, draft_ids(prompt), cache_d, cross_d, dims_d, compute_dtype)
    extra: Tuple[torch.Tensor, ...] = ()
    if no_speech is not None:
        sot_index, nospeech_id = no_speech
        extra = (torch.softmax(logits_t[:, sot_index, :].float(), dim=-1)[:, nospeech_id],)

    # Column l_buf is a sink: writes JAX drops (mode="drop") land there.
    buf = torch.full((b, l_buf + 1), eot, dtype=torch.long, device=device)
    tokens = buf[:, :l_buf]
    tokens[:, :p_len] = prompt
    first = argmax_last(constrain(logits_t[:, -1, :], tokens, p_len))
    tokens[:, p_len] = first
    finished = first == eot

    rows = torch.arange(b, device=device)
    offs = torch.arange(k + 1, device=device)  # window-relative positions
    pos = torch.full((b,), p_len + 1, dtype=torch.long, device=device)
    accepted = torch.zeros((), dtype=torch.long, device=device)
    rounds = 0

    while bool((~finished & (pos < total_len)).any()):
        # --- draft: k + 1 per-row greedy steps, each proposal written
        # provisionally so later steps' (and the verify's) rules see it ---
        prev = tokens[rows, pos - 1]
        prov_buf = buf.clone()
        prov = prov_buf[:, :l_buf]
        tok, drafts = prev, []
        for j in range(k + 1):
            logits, cache_d = decoder_step(
                params_d, draft_ids(tok), pos - 1 + j, cache_d, cross_d, dims_d, compute_dtype
            )
            tok = argmax_last(constrain(_fit_vocab(logits, n_vocab), prov, pos + j))
            prov_buf[rows, (pos + j).clamp(max=l_buf)] = tok
            drafts.append(tok)
        drafts = torch.stack(drafts[:k], dim=1)  # [B, k]; the (k+1)-th is dropped

        # --- verify: one target forward over [prev, d_1 .. d_k] ---
        window = torch.cat([prev[:, None], drafts], dim=1)
        logits_w, cache_t = decoder_window(
            params_t, window, pos - 1, cache_t, cross_t, dims_t, compute_dtype, tp=mesh
        )
        a = torch.stack(
            [argmax_last(constrain(logits_w[:, j, :], prov, pos + j)) for j in range(k + 1)], dim=1
        )  # [B, k+1]: the target's picks at pos .. pos + k

        # --- accept / commit ---
        m = torch.cumprod((a[:, :k] == drafts).long(), dim=1).sum(dim=1)  # leading matches
        adv = m + 1  # accepted drafts + (correction | bonus)
        is_eot = a == eot
        any_eot = is_eot.any(dim=1)
        first_eot = torch.argmax(is_eot.to(torch.int8), dim=1) + 1  # 1-based commit count
        adv = torch.where(any_eot, torch.minimum(adv, first_eot), adv)
        adv = torch.minimum(adv, total_len - pos)
        adv = torch.where(finished, 0, adv.clamp(min=0))
        commit = torch.where(offs[None, :] < adv[:, None], pos[:, None] + offs[None, :], l_buf)
        buf[rows[:, None], commit] = a
        # A clamped commit run of drafts is all drafts (an EOT proposal too).
        accepted += torch.where(finished, 0, torch.minimum(m, adv)).sum()
        finished = finished | (any_eot & (first_eot <= adv))
        pos = pos + adv
        finished = finished | (pos >= total_len)
        rounds += 1

    out_tokens = tokens[:, :total_len].clone()
    is_eot = out_tokens[:, p_len:] == eot
    first_eot = torch.argmax(is_eot.to(torch.int8), dim=1)
    lengths = torch.where(is_eot.any(dim=1), p_len + first_eot + 1, total_len)
    stats: Dict[str, int] = {
        "rounds": rounds,
        "drafted": rounds * k * b,
        "accepted": int(accepted),
    }
    return (out_tokens, lengths, stats) + extra
