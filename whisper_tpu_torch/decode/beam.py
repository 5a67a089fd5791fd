"""Beam search with beams folded into the batch axis, openai semantics.

Counterpart of ``whisper_tpu/decode/beam.py``. Hypotheses live as a
flattened [B·K] batch axis; cross-KV stays at batch B and is shared by an
utterance's beams (``models/decoder.py`` folds beam queries into the
cross-attention query rows). Per step: per-beam top-(K+1) over the vocab,
openai's candidate walk over the [B, K·(K+1)] pool, fill-no-replace
finished sets, then the continuation gather of tokens and KV cache.

Semantics are ``BeamSearchDecoder``'s (openai decoding.py), as in JAX: each
sample keeps up to K finished hypotheses; active beams are the top-K
non-EOT candidates; an EOT candidate is collected only if it sorts before
the K-th continuation; a full finished set never changes; decode stops
when every set is full or the budget ends; incomplete sets are padded from
the active beams in raw-score order; ranking is by score/length or the
GNMT penalty ``((5+len)/6)**p``.

Tie order is the JAX one: (score desc, candidate index asc). ``lax.top_k``
surfaces equal values lowest index first; ``torch.topk`` promises no order
among ties, so every top-k here is a stable descending sort
(:func:`_topk_stable`). ``torch.argmax`` returns the first maximal index,
as ``jnp.argmax`` does (greedy's ``argmax_last``, which takes the last, is
not used).

Three step modes (:func:`resolve_fused`), with equal results:

* ``"off"``: the eager step, then the cache reorder (:func:`reorder_cache`,
  K4 on a CUDA tensor) into a second buffer, and the two swap;
* ``"hybrid"``: ping-pong planes; the permutation chosen at a step is
  applied inside the next step by K2 (``decoder_step_fused``), by K2′ on
  a rank of a data-parallel mesh;
* ``"lineage"``: a slot-stationary cache and an ancestry mask
  (``decoder_step_lineage``); only the lineage table is permuted.

The port decodes eagerly into one preallocated cache of ``p_len +
max_new`` positions (no segment growth); each step decides on the host
whether to go on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.decode.logits import LogitRules
from whisper_tpu_torch.models.decoder import (
    KVCache,
    decoder_prefill,
    decoder_step,
    decoder_step_fused,
    decoder_step_lineage,
    init_kv_cache,
    init_lineage,
    plane_cache_from_prefill,
    precompute_cross_kv,
)
from whisper_tpu_torch.decode.greedy import all_on_host
from whisper_tpu_torch.models.params import Params
from whisper_tpu_torch.utils.profiling import annotate

NEG_INF = -1e30
MODES = ("off", "hybrid", "lineage")

# Decode steps run by beam_decode in this process (the prefill and the
# first expansion not counted): with the kernels' ``launches`` counts it
# shows which kernel ran how often.
steps = 0


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order (equal
    values lowest index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_wide(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a wide last axis (the vocab) as k argmax-and-mask
    passes, as in JAX. Equal values surface lowest index first (argmax
    takes the first maximum, and masking removes it before the next
    pass). Returns (values [..., k], indices [..., k] int64)."""
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, NEG_INF)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


class FinishedSet(NamedTuple):
    """Per-sample finished hypotheses, K fixed slots each."""

    tokens: torch.Tensor  # [B, K, L]
    scores: torch.Tensor  # [B, K] raw sum-logprob
    lengths: torch.Tensor  # [B, K] valid tokens incl. terminating EOT
    valid: torch.Tensor  # [B, K] bool


class Selection(NamedTuple):
    """Result of one candidate-selection round (see select_candidates)."""

    act_idx: torch.Tensor  # [B, K] candidate index per continuing beam slot
    act_scores: torch.Tensor  # [B, K]
    eot_idx: torch.Tensor  # [B, K] eligible EOT candidates, best first
    eot_scores: torch.Tensor  # [B, K]
    eot_valid: torch.Tensor  # [B, K] bool


def select_candidates(
    cand_scores: torch.Tensor,  # [B, C] joint scores, beam-major then rank
    cand_is_eot: torch.Tensor,  # [B, C] bool
    k: int,
) -> Selection:
    """openai's candidate walk, vectorized: continuations are the top-K
    non-EOT candidates; an EOT is eligible iff it sorts strictly before the
    K-th continuation (greater score, or equal score and lower index). The
    pool must hold ≥ K non-EOT entries (per-beam top-(K+1) guarantees it)."""
    idx = torch.arange(cand_scores.shape[1], device=cand_scores.device)[None, :]
    non_eot = torch.where(cand_is_eot, NEG_INF, cand_scores)
    act_scores, act_idx = _topk_stable(non_eot, k)
    kth_score = act_scores[:, -1:]
    kth_idx = act_idx[:, -1:]
    eligible = cand_is_eot & (
        (cand_scores > kth_score) | ((cand_scores == kth_score) & (idx < kth_idx))
    )
    eot_scores, eot_idx = _topk_stable(torch.where(eligible, cand_scores, NEG_INF), k)
    eot_valid = torch.gather(eligible, 1, eot_idx)
    return Selection(act_idx, act_scores, eot_idx, eot_scores, eot_valid)


def _insert_finished(
    fin: FinishedSet,
    new_tokens: torch.Tensor,  # [B, K, L] candidate buffers, best first
    new_scores: torch.Tensor,  # [B, K]
    new_lengths: torch.Tensor,  # [B, K]
    new_valid: torch.Tensor,  # [B, K]
) -> FinishedSet:
    """Fill-no-replace insertion (openai ``if len(finished) < beam_size``):
    existing entries keep their slots in arrival order; new candidates fill
    the remaining slots in their own (score) order; a full set never
    changes."""
    k = fin.scores.shape[1]
    slot = torch.arange(k, device=fin.scores.device)[None, :]
    # Priority keys: occupants 2K-i (K+1..2K), newcomers K-j (1..K), empty
    # or invalid -1. Existing always outrank new; both keep their order.
    keys = torch.cat(
        [
            torch.where(fin.valid, 2 * k - slot, -1),
            torch.where(new_valid, k - slot, -1),
        ],
        dim=1,
    )
    sel_keys, sel_pos = _topk_stable(keys, k)

    def pick(old, new):
        pool = torch.cat([old, new], dim=1)
        if pool.dim() == 3:
            return torch.gather(pool, 1, sel_pos[:, :, None].expand(-1, -1, pool.shape[2]))
        return torch.gather(pool, 1, sel_pos)

    return FinishedSet(
        tokens=pick(fin.tokens, new_tokens),
        scores=pick(fin.scores, new_scores),
        lengths=pick(fin.lengths, new_lengths),
        valid=sel_keys >= 1,
    )


def _lengths_of(tokens: torch.Tensor, p_len: int, eot: int) -> torch.Tensor:
    """Valid-token count incl. the terminating EOT; rows without EOT (budget
    exhausted) count the full buffer. greedy_decode's rule."""
    is_eot = tokens[..., p_len:] == eot
    first = torch.argmax(is_eot.to(torch.int8), dim=-1)
    return torch.where(is_eot.any(dim=-1), p_len + first + 1, tokens.shape[-1])


def resolve_fused(
    fused, dims: ModelDims, device: torch.device, kv_dtype: torch.dtype, tp: int = 1
) -> str:
    """The beam step mode → "off" | "hybrid" | "lineage".

    * ``"auto"``: "hybrid" for a CUDA cache whose geometry K2 takes, "off"
      on the CPU (as JAX's auto is eager off the TPU, so the CPU tests
      compare distinct formulations);
    * ``"hybrid"``, ``"lineage"``, ``"off"``: as asked; "hybrid" on a CUDA
      geometry K2 cannot take raises (on the CPU it runs K2's plain
      version);
    * ``True`` / ``False``: "hybrid" / "off", as in JAX.

    ``tp`` is the model-axis size of the mesh (1 without one, or on a
    data-parallel mesh, where "hybrid" runs K2′). K2's rows span the whole
    merged head dim, so as in JAX a tensor-parallel mesh refuses "hybrid":
    asked for, it raises; "auto" and ``True`` fall back to "off"."""
    from whisper_tpu_torch.ops.fused_step import supported

    device = torch.device(device)
    takes = supported(dims.n_text_state, kv_dtype.itemsize)
    if fused == "auto":
        return "hybrid" if device.type == "cuda" and takes and tp == 1 else "off"
    if fused is True:
        fused = "hybrid" if tp == 1 else "off"
    elif fused is False:
        fused = "off"
    if fused not in MODES:
        raise ValueError(f"fused_step must be 'auto', one of {MODES} or a bool, got {fused!r}")
    if fused == "hybrid" and tp > 1:
        raise ValueError(
            f"fused_step='hybrid' cannot run on a tensor-parallel mesh (model axis size "
            f"{tp}): K2's rows span the full merged head dim; use 'auto', 'lineage' or 'off'"
        )
    if fused == "hybrid" and device.type == "cuda" and not takes:
        raise ValueError(
            f"fused_step='hybrid': K2 does not take merged head dim "
            f"{dims.n_text_state} in {kv_dtype}; use 'auto', 'lineage' or 'off'"
        )
    return fused


def reorder_cache(
    cache: KVCache,
    gather_idx: torch.Tensor,
    bk: int,
    out: Optional[KVCache] = None,
) -> KVCache:
    """Beam-reshuffle the cache [L, B·K, ctx, H, Dh] along its beam axis:
    ``out[l, n] = cache[l, gather_idx[n]]``, through K4
    (``ops/gather.permute_rows``) — the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor. JAX's ``use_pallas`` switch has no
    counterpart: its other route, a one-hot matmul, is an XLA workaround
    with the same result. A permutation cannot run in place (rows repeat),
    so the result goes to ``out`` (a second cache) or a new one."""
    from whisper_tpu_torch.ops.gather import permute_rows

    if cache["k"].shape[1] != bk:
        raise ValueError(f"cache beam axis {cache['k'].shape[1]} != {bk}")
    idx = gather_idx.to(torch.int32)
    return {
        n: permute_rows(v, idx, out=None if out is None else out[n])
        for n, v in cache.items()
    }


def reorder_cache_window(
    cache: KVCache, gather_idx: torch.Tensor, bk: int, limit: int,
    out: Optional[KVCache] = None,
) -> KVCache:
    """:func:`reorder_cache` over the first ``limit`` positions only: the
    positions the decode has written. Without ``out``, positions ≥ limit
    keep the input's values (as JAX's in-place window update); with
    ``out``, they keep ``out``'s."""
    if out is None:
        out = {n: v.clone() for n, v in cache.items()}
    reorder_cache(
        {n: v[:, :, :limit] for n, v in cache.items()}, gather_idx, bk,
        out={n: v[:, :, :limit] for n, v in out.items()},
    )
    return out


def length_norm(gen_len: torch.Tensor, length_penalty: Optional[float]) -> torch.Tensor:
    """The divisor of a finished beam's score: its generated length, or
    the GNMT penalty ``((5 + len) / 6) ** length_penalty``. The 6 is a
    tensor on ``gen_len``'s device: CUDA's divide by a host scalar
    multiplies by its reciprocal, an ulp off JAX's divide for some
    lengths."""
    if length_penalty is None:
        return gen_len
    return ((5.0 + gen_len) / torch.full_like(gen_len, 6.0)) ** length_penalty


def beam_decode(
    params: Params,
    enc_out: torch.Tensor,  # [B, n_audio_ctx, d]
    prompt: torch.Tensor,  # [B, P] int
    dims: ModelDims,
    eot: int,
    max_new_tokens: int,
    beam_size: int = 5,
    logit_bias: Optional[torch.Tensor] = None,  # additive [n_vocab] f32
    rules: Optional[LogitRules] = None,
    length_penalty: Optional[float] = None,
    compute_dtype: torch.dtype = torch.float32,
    cross_kv: Optional[KVCache] = None,  # [L, B, H, Dh, Tk], shared by beams
    kv_cache_dtype: Optional[torch.dtype] = None,  # storage (None: compute dtype)
    no_speech: Optional[Tuple[int, int]] = None,  # (sot_index, nospeech_id)
    fused="auto",  # step mode, see resolve_fused
    mesh=None,  # parallel.mesh.Mesh when this is one rank of a mesh
) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens [B, P+max_new], lengths [B], scores [B]) of the best
    finished hypothesis per batch item (length-normalised score), plus
    (no_speech_probs [B],) when ``no_speech`` is given (the softmax
    probability of ``<|nospeech|>`` in the prefill logits at SOT).

    On a data-parallel ``mesh`` the B utterances are this rank's
    contiguous share, rank ``mesh.data_index`` of equal shares. Selection
    stays local, since a beam permutation never crosses samples; under
    "hybrid" the pending permutation is numbered by global row, ``(row0 +
    b) · K + src``, so that K2′ receives what JAX's shard receives. A model
    axis > 1 cuts the heads: the caches hold this rank's, every rank of the
    model group selects on the same all-reduced logits, and "off" reorders
    the local heads' rows through K4."""
    global steps
    b, p_len = prompt.shape
    k = beam_size
    bk = b * k
    total_len = p_len + max_new_tokens
    if total_len > dims.n_text_ctx:
        raise ValueError("prompt + max_new_tokens exceeds n_text_ctx")
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    store = kv_cache_dtype or compute_dtype
    tp = mesh.model_size if mesh is not None else 1
    mode = resolve_fused(fused, dims, device, store, tp=tp)
    # Global number of this rank's first beam row.
    row0 = mesh.data_index * bk if mesh is not None else 0
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, enc_out, dims, kv_dtype=kv_cache_dtype, tp=mesh)

    def logprobs_of(logits, tokens, pos):
        if logit_bias is not None:
            logits = logits + logit_bias
        if rules is not None:
            logits = rules.apply(logits, tokens, pos, p_len)
        return torch.log_softmax(logits.float(), dim=-1)

    with annotate("decode.loop", device=device) as loop:
        # --- prefill once per utterance (its beams are identical at the
        # prompt), then fan the cache out to the beam axis ---
        cache_b = init_kv_cache(dims, b, total_len, dtype=store, device=device, tp=mesh)
        logits, cache_b = decoder_prefill(
            params, prompt, cache_b, cross_kv, dims, compute_dtype, tp=mesh
        )
        out_extra: Tuple[torch.Tensor, ...] = ()
        if no_speech is not None:
            sot_index, nospeech_id = no_speech
            probs = torch.softmax(logits[:, sot_index, :].float(), dim=-1)
            out_extra = (probs[:, nospeech_id],)
        if mode == "hybrid":
            cache = plane_cache_from_prefill(cache_b, k)
        else:
            cache = {n: v.repeat_interleave(k, dim=1) for n, v in cache_b.items()}
        del cache_b

        tokens_b = torch.full((b, total_len), eot, dtype=torch.long, device=device)
        tokens_b[:, :p_len] = prompt
        lp0 = logprobs_of(logits[:, -1, :], tokens_b, p_len)  # [B, V]

        # First expansion: openai's dict dedups the K identical beams to one
        # candidate set of the top (K+1) tokens; the same selection walk applies.
        c0_scores, c0_tokens = topk_wide(lp0, k + 1)
        sel0 = select_candidates(c0_scores, c0_tokens == eot, k)
        tokens = tokens_b.repeat_interleave(k, dim=0)
        tokens[:, p_len] = torch.gather(c0_tokens, 1, sel0.act_idx).reshape(bk)
        scores = sel0.act_scores.reshape(bk)
        fin_tokens = tokens_b[:, None, :].expand(b, k, total_len)
        fin = FinishedSet(
            tokens=fin_tokens.clone(),
            scores=torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
            lengths=torch.full((b, k), p_len + 1, dtype=torch.long, device=device),
            valid=torch.zeros((b, k), dtype=torch.bool, device=device),
        )
        # Prefill EOTs: the prompt plus its terminating EOT (the buffer is
        # EOT-filled past the prompt already).
        fin = _insert_finished(fin, fin_tokens, sel0.eot_scores, fin.lengths, sel0.eot_valid)

        base = torch.arange(b, device=device)[:, None] * k
        cand_src = (torch.arange(k * (k + 1), device=device) // (k + 1))[None, :].expand(b, -1)

        def advance(s_tokens, s_scores, s_fin, lp, pos):
            """One selection round: openai's candidate walk, finished
            insertions, continuation gather. Returns (tokens, scores, fin,
            act_rows), act_rows the [B·K] source-beam permutation."""
            top_lp, top_tok = topk_wide(lp, k + 1)  # [BK, K+1]
            cand_scores = (s_scores[:, None] + top_lp).reshape(b, k * (k + 1))
            cand_tokens = top_tok.reshape(b, k * (k + 1))
            sel = select_candidates(cand_scores, cand_tokens == eot, k)
            # Finished insertions: the source beams' buffers already end in the
            # EOT fill at `pos`, so each is the hypothesis as it is.
            eot_rows = (base + torch.gather(cand_src, 1, sel.eot_idx)).reshape(bk)
            s_fin = _insert_finished(
                s_fin, s_tokens[eot_rows].reshape(b, k, total_len), sel.eot_scores,
                torch.full((b, k), pos + 1, dtype=torch.long, device=device), sel.eot_valid,
            )
            # Continuations: gather token buffers by source beam, write the token.
            act_rows = (base + torch.gather(cand_src, 1, sel.act_idx)).reshape(bk)
            new_tokens = s_tokens[act_rows]
            new_tokens[:, pos] = torch.gather(cand_tokens, 1, sel.act_idx).reshape(bk)
            return new_tokens, sel.act_scores.reshape(bk), s_fin, act_rows

        pos = p_len + 1  # next position to write
        if mode == "hybrid":
            parity = 0
            # Rows within a sample are identical after the fan-out: the first
            # pending permutation is the identity.
            pending = torch.arange(row0, row0 + bk, dtype=torch.int32, device=device)
        elif mode == "lineage":
            lineage = init_lineage(b, k, total_len, p_len, device=device)
        else:
            spare = {n: torch.empty_like(v) for n, v in cache.items()}
        # Each step decides on the host whether to go on: one small device →
        # host read per token.
        while pos < total_len and not all_on_host(fin.valid):
            with annotate("decode.step"):
                prev = tokens[:, pos - 1]
                if mode == "hybrid":
                    logits, cache = decoder_step_fused(
                        params, prev, pos - 1, cache, parity, pending, cross_kv, dims,
                        compute_dtype, beam_width=k, sharded=mesh is not None,
                    )
                elif mode == "lineage":
                    logits, cache, lineage = decoder_step_lineage(
                        params, prev, pos - 1, cache, lineage, cross_kv, dims, compute_dtype,
                        beam_width=k, tp=mesh,
                    )
                else:
                    logits, cache = decoder_step(
                        params, prev, pos - 1, cache, cross_kv, dims, compute_dtype, beam_width=k,
                        tp=mesh,
                    )
                lp = logprobs_of(logits, tokens, pos)
                tokens, scores, fin, act_rows = advance(tokens, scores, fin, lp, pos)
                if mode == "hybrid":
                    # Not applied now: the next step's K2 reads through it.
                    parity, pending = 1 - parity, (row0 + act_rows).to(torch.int32)
                elif mode == "lineage":
                    lineage = lineage[act_rows]
                else:
                    # The written window [0, pos) moves into the spare buffer.
                    cache, spare = reorder_cache_window(cache, act_rows, bk, pos, out=spare), cache
                steps += 1
            pos += 1

        # --- finalize: pad incomplete finished sets from the active beams in
        # raw-score order (their buffers already carry the EOT fill) ---
        pad_scores, pad_beam = _topk_stable(scores.reshape(b, k), k)
        pad_tokens = tokens[(base + pad_beam).reshape(bk)].reshape(b, k, total_len)
        fin = _insert_finished(
            fin, pad_tokens, pad_scores, _lengths_of(pad_tokens, p_len, eot),
            torch.ones((b, k), dtype=torch.bool, device=device),
        )

        # --- rank by normalised score (openai MaximumLikelihoodRanker) ---
        norm = length_norm(torch.clamp_min(fin.lengths - p_len, 1).float(), length_penalty)
        norm_scores = torch.where(fin.valid, fin.scores / norm, NEG_INF)
        best = torch.argmax(norm_scores, dim=1)
        rows = torch.arange(b, device=device)
        best_tokens, best_lengths = fin.tokens[rows, best], fin.lengths[rows, best]
        best_scores = norm_scores[rows, best]
        loop.set(steps=pos - p_len - 1)
    return (best_tokens, best_lengths, best_scores) + out_extra
