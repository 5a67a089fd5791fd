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

Given ``graphs`` (``decode/graph.StepGraphs``), a decode without
temperature and without a mesh runs each step after the first pick as a
replay of one captured CUDA graph: the step reads and writes static
buffers (the KV cache, cross-K/V, tokens, the finished flags, the
logprob sums) and its position from a device tensor it advances, and
reads a fixed window of the cache under a mask (``models/decoder.py``;
one graph per window, ``decode/graph.window``). The prefill, the first
pick and the host's loop test are those of the eager loop.
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.decode.graph import crop, cross_buffers, window
from whisper_tpu_torch.decode.logits import LogitRules
from whisper_tpu_torch.models.decoder import (
    KVCache,
    _decoder_forward,
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
    graphs=None,  # decode.graph.StepGraphs: replay the step as a CUDA graph where it applies
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
    store = kv_cache_dtype or compute_dtype
    entry = None
    if graphs is not None and temperature is None and mesh is None:
        cross_dtype = kv_cache_dtype or enc_out.dtype
        share = ("greedy", b, total_len, cross_dtype, store)
        key = share + (p_len, enc_out.shape[1], compute_dtype, eot, return_logprobs, id(params),
                       id(rules), id(logit_bias))

        def buffers():
            def zeros(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=device)

            return types.SimpleNamespace(
                cache=init_kv_cache(dims, b, total_len, dtype=store, device=device),
                cross=cross_buffers(dims, b, cross_dtype, device),
                tokens=zeros((b, total_len), torch.long), finished=zeros((b,), torch.bool),
                sum_lp=zeros((b,), torch.float32), pos=zeros((1,), torch.long),
            )

        entry = graphs.entry(key, buffers, keep=(params, rules, logit_bias), share=share)
        static_cross = crop(entry.buffers.cross, enc_out.shape[1])
    if cross_kv is None:
        cross_kv = precompute_cross_kv(
            params, enc_out, dims, kv_dtype=kv_cache_dtype, tp=mesh,
            out=None if entry is None else static_cross,
        )
    elif entry is not None:  # made ahead (detection's): into the step's buffers
        cross_kv = {n: static_cross[n].copy_(cross_kv[n]) for n in ("k", "v")}

    def pick(logits: torch.Tensor, tokens: torch.Tensor, pos):
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
        cache = entry.buffers.cache if entry is not None else init_kv_cache(
            dims, b, total_len, dtype=store, device=device, tp=mesh
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
        graphed = 0
        if entry is not None:
            st = entry.buffers
            st.tokens.copy_(tokens)
            st.finished.copy_(finished)
            if return_logprobs:
                st.sum_lp.copy_(sum_lp)
            st.pos.fill_(p_len)
            run = _graph_step(params, st, cross_kv, dims, compute_dtype, pick, eot,
                              return_logprobs)
            while pos < total_len and not all_on_host(st.finished):
                with annotate("decode.step"):
                    graphed += entry.step(run, window(pos - 1, total_len))
                    steps += 1
                pos += 1
            tokens = st.tokens.clone()
            sum_lp = st.sum_lp.clone() if return_logprobs else None
        else:
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
        loop.set(steps=pos - p_len - 1, graphed=graphed)
    return (tokens, lengths) + out_extra


def _graph_step(params, st, cross, dims, compute_dtype, pick, eot: int, return_logprobs: bool):
    """The greedy step on static buffers ``st`` (a ``StepGraphs`` entry's)
    and ``cross`` (the crop of its cross-K/V), at the position held in
    ``st.pos`` (the token fed; the pick lands one further), which it
    advances: the eager loop's step with every position read on the card.
    ``run(w)`` reads the cache's first ``w`` positions."""
    b = st.tokens.shape[0]

    def run(w: int) -> None:
        at = st.pos.expand(b)
        cache = {n: c[:, :, :w] for n, c in st.cache.items()}
        logits, _ = _decoder_forward(
            params, st.tokens.gather(1, at[:, None]), at, cache, cross, dims, compute_dtype
        )
        nxt, lp = pick(logits[:, 0], st.tokens, at + 1)
        if return_logprobs:  # frozen rows stop adding
            st.sum_lp.add_(torch.where(st.finished, 0.0, lp))
        nxt = torch.where(st.finished, eot, nxt)
        st.tokens.scatter_(1, (at + 1)[:, None], nxt[:, None])
        st.finished.logical_or_(nxt == eot)
        st.pos.add_(1)

    return run


def lm_greedy_decode(
    params: Params,
    x: torch.Tensor,  # [B, P, D] prefix embeddings, left-padded
    pad: torch.Tensor,  # [B] int64 on x's device: each row's left padding
    dims,  # config.AudioLMDims
    max_new_tokens: int,
    counters: Optional[torch.Tensor] = None,  # models.audio_lm.new_counters
    graphs=None,  # decode.graph.StepGraphs: replay the step as a CUDA graph on the card
    routes: Optional[dict] = None,  # receives "prefill" and "step": the routing of every position
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding of an audio language model (``models/audio_lm.py``)
    from its prefix → (tokens [B, max_new_tokens]: the generated ids, the
    stop id ``dims.stop`` after a row's first; lengths [B]: generated ids up
    to and including the first stop, else the budget).

    The prefill (span ``lm.prefill``) writes the prefix's keys and values
    into one cache of ``P + max_new_tokens`` positions; every row's next
    token then lands at the same cache index. Given ``graphs``, each step
    after the first pick is a replay of a captured graph, as in
    :func:`greedy_decode`: the step reads its cache index from a device
    tensor it advances and a window of the cache under a mask. The eager
    steps read the same windows, so both run the same shapes. Given
    ``routes``, its ``"prefill"`` (int8 [L, B, P, K]) and ``"step"`` (int8
    [L, B, max_new_tokens, K]; index g: the step that fed generated token g)
    are set to the routing of every position (``audio_lm.route_codes``),
    on the device; a captured step always records its own."""
    from whisper_tpu_torch.models import audio_lm

    global steps
    b, p, _ = x.shape
    total = p + max_new_tokens
    device = x.device
    stop = dims.stop
    entry = None
    if graphs is not None:
        share = ("lm", b, total, x.dtype)
        key = share + (p, id(params), id(counters))

        def buffers():
            return types.SimpleNamespace(
                cache=audio_lm.init_cache(dims, b, total, x.dtype, device),
                tokens=torch.zeros((b, max_new_tokens), dtype=torch.long, device=device),
                finished=torch.zeros((b,), dtype=torch.bool, device=device),
                pos=torch.zeros((1,), dtype=torch.long, device=device),
                pad=torch.zeros((b,), dtype=torch.long, device=device),
                routes=torch.full((dims.n_layer, b, max_new_tokens, dims.top_k), -1,
                                  dtype=torch.int8, device=device),
            )

        entry = graphs.entry(key, buffers, keep=(params, counters), share=share)

    with annotate("decode.loop", device=device) as loop:
        cache = entry.buffers.cache if entry is not None else audio_lm.init_cache(
            dims, b, total, x.dtype, device)
        pre_routes = step_routes = None
        if routes is not None:
            pre_routes = torch.empty((dims.n_layer, b, p, dims.top_k), dtype=torch.int8,
                                     device=device)
            step_routes = entry.buffers.routes if entry is not None else torch.full(
                (dims.n_layer, b, max_new_tokens, dims.top_k), -1, dtype=torch.int8, device=device)
            routes.update(prefill=pre_routes, step=step_routes)
        with annotate("lm.prefill", device=device, rows=b, prefix_len=p):
            logits = audio_lm.prefill(params, x, pad, cache, dims, counters, pre_routes)
        tokens = torch.full((b, max_new_tokens), stop, dtype=torch.long, device=device)
        tokens[:, 0] = torch.argmax(logits, dim=-1)
        finished = tokens[:, 0] == stop
        g = 1  # the next generated index
        graphed = 0
        if entry is not None:
            st = entry.buffers
            st.tokens.copy_(tokens)
            st.finished.copy_(finished)
            st.pad.copy_(pad)
            st.pos.fill_(p)
            st.routes.fill_(-1)
            run = _lm_graph_step(params, st, dims, p, counters)
            while g < max_new_tokens and not all_on_host(st.finished):
                with annotate("decode.step"):
                    graphed += entry.step(run, window(p + g - 1, total))
                    steps += 1
                g += 1
            tokens = st.tokens.clone()
        else:
            at = torch.full((1,), p, dtype=torch.long, device=device)
            while g < max_new_tokens and not all_on_host(finished):
                with annotate("decode.step"):
                    logits = audio_lm.step(params, tokens[:, g - 1], at, pad, cache,
                                           window(p + g - 1, total), dims, counters, step_routes,
                                           at - p)
                    steps += 1
                    nxt = torch.where(finished, stop, torch.argmax(logits, dim=-1))
                    tokens[:, g] = nxt
                    finished = finished | (nxt == stop)
                    at.add_(1)
                g += 1
        is_stop = tokens == stop
        first = torch.argmax(is_stop.to(torch.int8), dim=1)
        lengths = torch.where(is_stop.any(dim=1), first + 1, max_new_tokens)
        loop.set(steps=g - 1, graphed=graphed)
    return tokens, lengths


def _lm_graph_step(params, st, dims, p: int, counters):
    """The audio LM's step on static buffers ``st`` at the cache index held
    in ``st.pos`` (the token fed is generated index ``pos - p``; the pick
    lands one further), which it advances, and records its routing in
    ``st.routes``. ``run(w)`` reads the cache's first ``w`` positions."""
    from whisper_tpu_torch.models import audio_lm

    b = st.tokens.shape[0]

    def run(w: int) -> None:
        g = st.pos - p
        fed = g.expand(b)[:, None]
        logits = audio_lm.step(params, st.tokens.gather(1, fed)[:, 0], st.pos, st.pad, st.cache,
                               w, dims, counters, st.routes, g)
        nxt = torch.where(st.finished, dims.stop, torch.argmax(logits, dim=-1))
        st.tokens.scatter_(1, fed + 1, nxt[:, None])
        st.finished.logical_or_(nxt == dims.stop)
        st.pos.add_(1)

    return run
