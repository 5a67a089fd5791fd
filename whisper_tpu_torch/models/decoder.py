"""Text decoder with KV-cached self-attention and precomputed cross-attention.

Counterpart of ``whisper_tpu/models/decoder.py``: ``init_kv_cache``,
``precompute_cross_kv``, ``_decoder_forward`` for a shared (scalar)
position with beam widths or per-row positions (T = 1, the slot pool of
``decode/continuous.py``; T > 1, the speculative verify window of
``decoder_window``), ``decoder_prefill``, ``decoder_step``, and the
beam step modes: ``plane_cache_from_prefill`` + ``decoder_step_fused``
("hybrid", through K2, or K2′ on a rank of a data-parallel mesh) and
``init_lineage`` + ``decoder_step_lineage`` ("lineage"). ``merged_read``
and the segment-growth helpers (``grow_plane_cache``, ``grow_lineage``)
are not ported: the port preallocates one cache of ``p_len + max_new``
positions.

Layouts are the JAX ones: self-attention cache ``{"k"/"v": [L, B, ctx, H,
Dh]}``, cross-attention K/V ``{"k"/"v": [L, B, H, Dh, n_audio_ctx]}``
(head-major, sequence-minor), hybrid planes ``{"k"/"v": [2, L, B·K, ctx,
H·Dh]}``. Caches hold the storage dtype (``kv_cache_dtype``, e.g. fp8);
new K/V rows are cast to it on write. Where JAX returns an updated copy of
the cache, the port writes the new rows into the cache in place and
returns it.

Every mode runs the one layer loop :func:`_layers` and passes it only its
self-attention cache write and read. That read is one
``layers.qkv_attention`` call over the written window ``[0, pos]`` with no
mask (a causal mask for the prefill, an ancestry bias for lineage): the rows JAX reads
past it carry mask -1e30 and weigh exactly 0 in f32. So the eager step
after a cache reorder and the hybrid step run the same arithmetic on the
same bytes, and their logits are bitwise equal on any device. With
per-row positions the rows end at different depths, so the read covers
the whole cache under a per-row mask, as JAX's does.

A position held in a device tensor (the step of a CUDA graph,
``decode/graph.py``, which fixes every shape and address) takes a fixed
read window past it, chosen by the caller, under a mask: greedy through
the per-row form (with every row at that position) over a cache cut to
the window, the hybrid step under :func:`position_mask`. The masked
positions weigh exactly 0, so the result equals the window read up to
the order of the sums; the positions past ``pos`` must hold finite
values (the graphs' caches are zero-filled when they are allocated).

Tensor parallelism (``tp``: this rank's ``parallel.mesh.Mesh``): the
caches and cross-K/V hold this rank's ``n_text_head / m`` heads, and a
forward makes ``2 + 3 · n_text_layer`` collectives (the embedding's gather,
the self-attention o, cross-attention o and fc2 of every layer, the
logits). The hybrid step (K2) is not run there: its rows span every head,
so ``decode/beam.resolve_fused`` refuses it on a model axis > 1, as JAX
does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.params import Params
from whisper_tpu_torch.parallel import collectives
from whisper_tpu_torch.parallel.collectives import local_heads

KVCache = Dict[str, torch.Tensor]

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free for
# fully-masked (not yet written) cache rows


def init_kv_cache(
    dims: ModelDims,
    batch: int,
    max_len: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
    tp=None,
) -> KVCache:
    """Self-attention cache [L, batch, max_len, H, Dh] (H: this rank's
    heads under ``tp``), zeros."""
    max_len = max_len or dims.n_text_ctx
    h, dh = local_heads(dims.n_text_head, tp), dims.n_text_state // dims.n_text_head
    shape = (dims.n_text_layer, batch, max_len, h, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def precompute_cross_kv(
    params: Params,
    enc_out: torch.Tensor,
    dims: ModelDims,
    kv_dtype: Optional[torch.dtype] = None,
    tp=None,
    out: Optional[KVCache] = None,
) -> KVCache:
    """Cross-attention K/V over encoder states, computed once per utterance:
    [L, B, H, Dh, n_audio_ctx] (H: this rank's heads under ``tp``, from its
    column-parallel k and v; no collective). ``kv_dtype`` optionally sets
    the storage dtype (e.g. ``torch.float8_e4m3fn``; attention upcasts at
    use). ``out``: buffers of that shape and dtype to write into (a
    captured step's static cross-K/V) and return."""
    n_head = local_heads(dims.n_text_head, tp)
    ks, vs = [], []
    for bp in params["decoder"]["blocks"]:
        k = layers.split_heads(layers.linear(bp["cross"]["k"], enc_out), n_head)
        v = layers.split_heads(layers.linear(bp["cross"]["v"], enc_out), n_head)
        k = k.permute(0, 2, 3, 1)  # [B, Tk, H, Dh] → [B, H, Dh, Tk]
        v = v.permute(0, 2, 3, 1)
        if kv_dtype is not None:
            k, v = k.to(kv_dtype), v.to(kv_dtype)
        ks.append(k)
        vs.append(v)
    if out is None:
        return {"k": torch.stack(ks), "v": torch.stack(vs)}
    torch.stack(ks, out=out["k"])
    torch.stack(vs, out=out["v"])
    return out


def _embed_at(dec, tokens: torch.Tensor, pos, end, compute_dtype, tp=None) -> torch.Tensor:
    """Token plus positional embedding for positions [pos, end), in the
    compute dtype; a one-element device tensor ``pos`` (T = 1) indexes the
    table's row, and ``end`` is not read."""
    table = dec["pos_emb"]
    rows = table[pos] if isinstance(pos, torch.Tensor) else table[pos:end]
    return (layers.embed(dec["tok_emb"], tokens, tp) + rows).to(compute_dtype)


def position_mask(pos: torch.Tensor, ctx: int, dtype: torch.dtype) -> torch.Tensor:
    """[ctx] additive mask of one query at the position held in ``pos`` (a
    one-element int64 tensor) over a cache of ``ctx`` positions: 0 at
    positions ``<= pos``, -1e30 past it. Built once per step, shared by
    every layer."""
    k_pos = torch.arange(ctx, device=pos.device)
    return torch.where(k_pos <= pos, 0.0, NEG_INF).to(dtype)


def scatter_rows(dst: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``dst[b, pos[b]] = new[b]`` for every row b (``pos`` [B]), or
    ``dst[b, pos[b, i]] = new[b, i]`` (``pos`` [B, T]), cast to ``dst``'s
    dtype, in place. ``dst`` [B, ctx, ...] (last dim contiguous), ``pos``
    int64, ``new`` [B, ...] or [B, T, ...]. The write goes through byte
    views of both sides: the same bytes for every dtype, fp8 included, where
    CUDA's ``index_put_`` may lack a float8 kernel."""
    rows = torch.arange(dst.shape[0], device=dst.device).view(-1, *([1] * (pos.dim() - 1)))
    dst.view(torch.uint8)[rows, pos] = new.to(dst.dtype).contiguous().view(torch.uint8)


def _rows_forward(dec, tokens, pos, cache, cross_kv, dims, compute_dtype, tp=None):
    """The per-row form of :func:`_decoder_forward`: row ``b``'s tokens sit
    at ``pos[b] + i``, i < T. The embedding gathers each row's positions,
    clamped to the table's last row (a speculative window may reach past
    ``n_text_ctx`` into slack rows whose tokens are never emitted: JAX's
    docstring says its gather clips there, and an unclamped gather would
    raise); each row's new K/V rows are written at its own positions by
    index; the read covers the whole cache, and a per-row mask leaves query
    ``i`` the keys at positions ``<= pos[b] + i``, as JAX's per-row branch
    does. Positions written must lie in the cache (the slot pool clamps its
    inactive rows'; the speculative decode sizes its cache with slack)."""
    t = tokens.shape[1]
    ctx = cache["k"].shape[2]
    pos = pos.to(device=tokens.device, dtype=torch.long)
    table = dec["pos_emb"]
    if t == 1:
        row_pos = pos
        pos_emb = table[pos.clamp(max=table.shape[0] - 1)][:, None]
    else:
        row_pos = pos[:, None] + torch.arange(t, device=pos.device)[None, :]  # [B, T]
        pos_emb = table[row_pos.clamp(max=table.shape[0] - 1)]
    x = (layers.embed(dec["tok_emb"], tokens, tp) + pos_emb).to(compute_dtype)
    k_pos = torch.arange(ctx, device=x.device)
    q_pos = row_pos[:, None] if t == 1 else row_pos  # [B, T]
    mask = torch.where(k_pos[None, None, :] <= q_pos[:, :, None], 0.0, NEG_INF)
    mask = mask.to(compute_dtype)[:, None]  # [B, 1, T, ctx]

    def self_kv(layer, q, k_new, v_new):
        if t == 1:
            scatter_rows(cache["k"][layer], pos, k_new[:, 0])
            scatter_rows(cache["v"][layer], pos, v_new[:, 0])
        else:
            scatter_rows(cache["k"][layer], row_pos, k_new)
            scatter_rows(cache["v"][layer], row_pos, v_new)
        return q, cache["k"][layer], cache["v"][layer], mask

    n_head = local_heads(dims.n_text_head, tp)
    return _layers(dec, x, n_head, cross_kv, 1, self_kv, tp), cache


def _cross_block(bp, x, n_head, xk_l, xv_l, beam_width: int, tp=None) -> torch.Tensor:
    """Residual cross-attention over precomputed encoder K/V. Beams fold
    into the query-row axis: [B·K, T, H, Dh] → [B, K·T, H, Dh] against
    cross-KV stored at batch B, which is never replicated."""
    hn = layers.layer_norm(bp["ln2"], x)
    qx = layers.split_heads(layers.linear(bp["cross"]["q"], hn), n_head)
    bk, t, h, dh = qx.shape
    out = layers.cross_attention_T(
        qx.reshape(bk // beam_width, beam_width * t, h, dh), xk_l, xv_l
    ).reshape(bk, t, h, dh)
    return x + layers.linear(bp["cross"]["o"], layers.merge_heads(out), tp=tp)


def _layers(dec, x, n_head, cross_kv, beam_width: int, self_kv, tp=None) -> torch.Tensor:
    """The decoder's layer stack and unembedding over embedded tokens ``x``
    [BK, T, d], shared by every step mode. Only the self-attention's cache
    differs between them: ``self_kv(layer, q, k_new, v_new)`` stores the new
    K/V rows ([BK, T, H, Dh]) and returns the operands ``(q, k, v, mask)``
    of the one ``layers.qkv_attention`` call, whose output is reshaped back
    to ``q``'s shape. ``n_head``: this rank's heads. Returns logits [BK, T,
    n_vocab] float32."""
    for layer, bp in enumerate(dec["blocks"]):
        hn = layers.layer_norm(bp["ln1"], x)
        q, k_new, v_new = (
            layers.split_heads(layers.linear(bp["attn"][n], hn), n_head) for n in "qkv"
        )
        attn = layers.qkv_attention(*self_kv(layer, q, k_new, v_new)).reshape(q.shape)
        x = x + layers.linear(bp["attn"]["o"], layers.merge_heads(attn), tp=tp)
        x = _cross_block(
            bp, x, n_head, cross_kv["k"][layer], cross_kv["v"][layer], beam_width, tp
        )
        x = x + layers.mlp(bp["mlp"], layers.layer_norm(bp["ln3"], x), tp=tp)
    return layers.unembed(dec["tok_emb"], layers.layer_norm(dec["ln"], x), tp)


def _decoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int64
    pos_offset: Union[int, torch.Tensor],  # absolute position of tokens[:, 0]:
    # an int shared by all rows, or [B] integers, one per row
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    beam_width: int = 1,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Shared body for prefill (T = prompt length) and step (T = 1).

    The self-attention read covers cache positions ``0 .. pos_offset+T-1``:
    the positions JAX leaves unmasked. The rows JAX reads past them carry
    mask -1e30 and weigh exactly 0 in f32, so the result is the same.
    ``beam_width=K``: the batch axis is a folded [B·K] beam axis while
    ``cross_kv`` stays at batch B (see :func:`_cross_block`). A ``[B]``
    tensor ``pos_offset`` takes :func:`_rows_forward`.
    Returns (logits [B, T, n_vocab] float32, cache)."""
    dec = params["decoder"]
    if isinstance(pos_offset, torch.Tensor):
        if beam_width != 1:
            raise ValueError("per-row positions decode one hypothesis per row")
        return _rows_forward(dec, tokens, pos_offset, cache, cross_kv, dims, compute_dtype, tp)
    t = tokens.shape[1]
    end = pos_offset + t
    if end > cache["k"].shape[2]:
        raise ValueError(f"positions up to {end} exceed the cache length")

    x = _embed_at(dec, tokens, pos_offset, end, compute_dtype, tp)

    # Causal mask over the read window: query at absolute position
    # pos_offset + i sees keys at positions <= that. A single new token sees
    # the whole window, so its mask is all zeros and is skipped.
    mask = None
    if t > 1:
        q_pos = pos_offset + torch.arange(t, device=x.device)[:, None]
        k_pos = torch.arange(end, device=x.device)[None, :]
        mask = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(compute_dtype)

    def self_kv(layer, q, k_new, v_new):
        cache["k"][layer, :, pos_offset:end] = k_new.to(cache["k"].dtype)
        cache["v"][layer, :, pos_offset:end] = v_new.to(cache["v"].dtype)
        return q, cache["k"][layer, :, :end], cache["v"][layer, :, :end], mask

    n_head = local_heads(dims.n_text_head, tp)
    return _layers(dec, x, n_head, cross_kv, beam_width, self_kv, tp), cache


@collectives.stage("window")
def decoder_window(
    params: Params,
    tokens: torch.Tensor,  # [B, T] — T consecutive tokens per row
    pos: torch.Tensor,  # [B] — absolute position of tokens[:, 0], per row
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Multi-token forward at per-row absolute positions: the speculative
    verify pass (``decode/speculative.py``), one target forward that scores
    a whole window of draft proposals and writes their K/V rows in place.
    Row b's window covers positions ``pos[b] .. pos[b] + T - 1``; the caller
    keeps them inside the cache. Returns (logits [B, T, V] f32, cache)."""
    return _decoder_forward(params, tokens, pos, cache, cross_kv, dims, compute_dtype, tp=tp)


@collectives.stage("prefill")
def decoder_prefill(
    params: Params,
    prompt: torch.Tensor,  # [B, P]
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the static prompt through the decoder once, filling cache[0:P].
    Returns (logits [B, P, V], cache)."""
    return _decoder_forward(params, prompt, 0, cache, cross_kv, dims, compute_dtype, tp=tp)


@collectives.stage("step")
def decoder_step(
    params: Params,
    token: torch.Tensor,  # [B] — token at absolute position `pos`
    pos: Union[int, torch.Tensor],  # shared int, or [B] per-row positions
    cache: KVCache,
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    beam_width: int = 1,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step. ``beam_width=K``: the token and cache batch
    axis is [B·K] while ``cross_kv`` stays at B. Returns (logits [B, V],
    cache)."""
    if not (isinstance(pos, torch.Tensor) and pos.ndim == 1):
        pos = int(pos)
    logits, cache = _decoder_forward(
        params, token[:, None], pos, cache, cross_kv, dims, compute_dtype,
        beam_width=beam_width, tp=tp,
    )
    return logits[:, 0, :], cache


def plane_cache_from_prefill(cache: KVCache, beam: int, out: Optional[KVCache] = None) -> KVCache:
    """Prefilled cache [L, B, ctx, H, Dh] → the ping-pong plane pair [2, L,
    B·beam, ctx, H·Dh] of the hybrid step (each utterance's rows repeated
    ``beam`` times, beam-minor, as ``jnp.repeat``). Plane 0 holds the
    fanned-out prefill and is the first step's read plane; plane 1 starts
    as zeros and is written before it is read. ``out``: planes to write
    plane 0 into (a captured step's static planes; plane 1 keeps what it
    holds) and return."""
    l, b, ctx, h, dh = cache["k"].shape

    def fan(x, planes):
        if planes is None:
            planes = x.new_zeros((2, l, b * beam, ctx, h * dh))
        planes[0] = x.reshape(l, b, ctx, h * dh).repeat_interleave(beam, dim=1)
        return planes

    return {n: fan(cache[n], None if out is None else out[n]) for n in ("k", "v")}


def decoder_step_fused(
    params: Params,
    token: torch.Tensor,  # [BK] — token at absolute position `pos`
    pos: Union[int, torch.Tensor],  # an int, or a one-element int64 device tensor
    cache: KVCache,  # {"k"/"v": [2, L, BK, ctx, H·Dh]} ping-pong planes
    parity: int,  # plane to READ; this step writes plane 1 - parity
    pending_idx: torch.Tensor,  # [BK] int32 — beam permutation chosen at the
    # previous step's selection, applied by K2 inside this step
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    beam_width: int = 1,
    sharded: bool = False,  # a rank of a data-parallel mesh: the cache holds
    # this rank's rows and pending_idx their GLOBAL source rows (K2′)
    window: Optional[int] = None,  # with a device pos: positions read (default ctx)
) -> Tuple[torch.Tensor, KVCache]:
    """One beam step with the pending permutation applied by K2
    (``ops/fused_step.permute_append``): per layer, K2 makes plane ``1 -
    parity`` the permuted read plane plus this step's K/V rows at ``pos``,
    then the self-attention reads plane ``1 - parity`` over ``[0, pos]``
    through the same ``layers.qkv_attention`` call as the eager step (the
    [BK, ctx, H·Dh] plane slice is a free [BK, ctx, H, Dh] view). So the
    result equals :func:`decoder_step` after a cache reorder by
    ``pending_idx``, bitwise. JAX's block-diagonal merged read, which suits
    XLA on the TPU's matrix unit, is not carried over.

    A device tensor ``pos`` (the step of a CUDA graph): K2 reads the
    position on the card, and the read covers the plane's first ``window``
    positions (all of them by default; ``pos`` must lie below it) under
    :func:`position_mask`, equal to the window read up to the order of the
    sums. Not on a mesh.

    ``sharded``: the per-layer call is K2′ (``permute_append_sharded``,
    which makes the global rows local with ``beam_width``), as JAX's step
    on a mesh (``mesh=``) runs it per data shard.

    Returns (logits [BK, V] f32, cache with plane ``1 - parity`` current);
    the caller flips the parity."""
    from whisper_tpu_torch.ops.fused_step import permute_append, permute_append_sharded

    dec = params["decoder"]
    parity = int(parity)
    ck, cv = cache["k"], cache["v"]
    if isinstance(pos, torch.Tensor):
        if sharded:
            raise ValueError("a device position is not taken on a data-parallel mesh (K2′)")
        w = window or ck.shape[3]
        mask = position_mask(pos, w, compute_dtype)
    else:
        pos = int(pos)
        w, mask = pos + 1, None
    x = _embed_at(dec, token[:, None], pos, w, compute_dtype)

    def self_kv(layer, q, k_new, v_new):
        bk, _, h, dh = k_new.shape
        rows = (k_new.reshape(bk, h * dh), v_new.reshape(bk, h * dh))
        if sharded:
            permute_append_sharded(ck, cv, pending_idx, layer, pos, parity, *rows, beam=beam_width)
        else:
            permute_append(ck, cv, pending_idx, layer, pos, parity, *rows)
        win = (p[1 - parity, layer, :, :w].view(bk, w, h, dh) for p in (ck, cv))
        return (q, *win, mask)

    return _layers(dec, x, dims.n_text_head, cross_kv, beam_width, self_kv)[:, 0, :], cache


def init_lineage(
    b: int, beam: int, ctx: int, p_len: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """[B·K, ctx] int32 slot-ancestry table of the lineage step: entry [r, t]
    is the slot (0..K-1, within r's utterance) whose row holds position t's
    K/V on r's ancestry path, -1 where t is unwritten. Prefill positions
    point at the row's own slot (the fan-out copied the prefill into every
    slot)."""
    own = (torch.arange(b * beam, dtype=torch.int32, device=device) % beam)[:, None]
    written = torch.arange(ctx, device=device)[None, :] < p_len
    return torch.where(written, own, torch.full_like(own, -1))


@collectives.stage("step")
def decoder_step_lineage(
    params: Params,
    token: torch.Tensor,  # [B·K] — token at absolute position `pos`
    pos: int,
    cache: KVCache,  # {"k"/"v": [L, B·K, ctx, H, Dh]}, slot-stationary
    lineage: torch.Tensor,  # [B·K, ctx] int32 (see init_lineage)
    cross_kv: KVCache,
    dims: ModelDims,
    compute_dtype: torch.dtype = torch.float32,
    beam_width: int = 1,
    tp=None,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """One beam step with the beam permutation turned into a mask: every
    logical beam writes position ``pos`` into its own slot, and attention
    runs over all K slots' rows of its utterance with a bias that is 0
    where ``lineage[r, t] == slot`` and -1e30 elsewhere (masked entries
    weigh exactly 0 in f32). The cache never moves; the caller permutes
    the lineage rows. Pure tensor code, no kernel, as in JAX. Reads the
    window [0, pos] of each slot.

    Returns (logits [B·K, V] f32, cache, lineage), the cache and the
    lineage written in place: the new rows at ``pos`` and lineage column
    ``pos`` set to each row's own slot."""
    dec = params["decoder"]
    n_head = local_heads(dims.n_text_head, tp)
    bk = token.shape[0]
    kw = beam_width
    b = bk // kw
    pos = int(pos)
    w = pos + 1
    dh = dims.n_text_state // dims.n_text_head

    x = _embed_at(dec, token[:, None], pos, pos + 1, compute_dtype, tp)
    own = torch.arange(bk, dtype=torch.int32, device=lineage.device) % kw
    lineage[:, pos] = own
    # Bias over the flattened (slot, position) key axis, shared by every
    # layer: [B, 1, K, K·w].
    slot = torch.arange(kw, dtype=torch.int32, device=lineage.device)
    lin3 = lineage[:, :w].reshape(b, kw, w)
    bias = torch.where(lin3[:, :, None, :] == slot[None, None, :, None], 0.0, NEG_INF)
    bias = bias.reshape(b, kw, kw * w)[:, None]

    def self_kv(layer, q, k_new, v_new):
        cache["k"][layer, :, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][layer, :, pos] = v_new[:, 0].to(cache["v"].dtype)
        # [BK, w, H, Dh] → [B, K·w, H, Dh]: slots fold into the key axis,
        # the K queries of an utterance into its query rows.
        k4, v4 = (cache[n][layer, :, :w].reshape(b, kw * w, n_head, dh) for n in "kv")
        return q.reshape(b, kw, n_head, dh), k4, v4, bias

    logits = _layers(dec, x, n_head, cross_kv, kw, self_kv, tp)
    return logits[:, 0, :], cache, lineage
