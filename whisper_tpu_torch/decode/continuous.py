"""Continuous (slot-based) batched decoding.

Counterpart of ``whisper_tpu/decode/continuous.py``. The decoder state is a
fixed pool of ``n_slots`` *slots*, one utterance per slot, every slot at its
own decode depth, advanced together one token per step. When a slot emits
EOT it is harvested and refilled with a freshly prefilled utterance while
its neighbours keep decoding.

* a slot is one fixed-size KV region per utterance (Whisper's decode is
  capped at ``n_text_ctx``), so there are no page tables and no gather
  on the attention path;
* all shapes are fixed: ``[L, S, ctx, H, Dh]`` caches, ``[S]``
  position / active vectors. Occupancy is data (the ``active`` mask), never
  a shape;
* per-slot depths use the per-row form of the decoder
  (``models/decoder._rows_forward``): one indexed write per layer.

Where JAX donates the state's buffers to each compiled program, the port
preallocates them once and updates them in place: every function here
that changes a :class:`SlotState` writes into its tensors and returns it.
Host-side orchestration (slot bookkeeping, harvest, refill) lives in
``engine/serving.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.decode.greedy import argmax_last
from whisper_tpu_torch.decode.logits import LogitRules
from whisper_tpu_torch.models.decoder import (
    KVCache,
    decoder_prefill,
    decoder_step,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.models.params import Params


class SlotState(NamedTuple):
    """Device-resident state of the slot pool. All tensors have a leading or
    second slot axis of size S; occupancy is carried in ``active``."""

    tokens: torch.Tensor  # [S, total_len] int64 — prompt + generated (+ eot fill)
    pos: torch.Tensor  # [S] int64 — next position each slot will write
    active: torch.Tensor  # [S] bool — decoding (occupied slots that are done
    # and empty slots both read False; the host tells them apart)
    cache: KVCache  # {"k","v"}: [L, S, total_len, H, Dh]
    cross_kv: KVCache  # {"k","v"}: [L, S, H, Dh, n_audio_ctx]


class SlotPack(NamedTuple):
    """Prefilled utterances ready for insertion, one row per utterance: the
    same tensors as SlotState minus ``active`` (insertion implies True)."""

    tokens: torch.Tensor  # [B, total_len]
    pos: torch.Tensor  # [B]
    still_active: torch.Tensor  # [B] bool — False if EOT fired at prefill
    cache: KVCache  # [L, B, total_len, H, Dh]
    cross_kv: KVCache  # [L, B, H, Dh, n_audio_ctx]


def init_slot_state(
    dims: ModelDims,
    n_slots: int,
    total_len: int,
    eot: int,
    cache_dtype: torch.dtype = torch.float32,
    kv_dtype: Optional[torch.dtype] = None,
    audio_ctx: Optional[int] = None,  # EngineConfig.audio_ctx crop: the
    # per-slot cross-KV is stored at the cropped width
    device: torch.device | str = "cpu",
) -> SlotState:
    h, dh = dims.n_text_head, dims.n_text_state // dims.n_text_head
    n_ac = min(audio_ctx or dims.n_audio_ctx, dims.n_audio_ctx)
    cross_shape = (dims.n_text_layer, n_slots, h, dh, n_ac)
    cross_dtype = kv_dtype or cache_dtype
    return SlotState(
        tokens=torch.full((n_slots, total_len), eot, dtype=torch.long, device=device),
        pos=torch.zeros((n_slots,), dtype=torch.long, device=device),
        active=torch.zeros((n_slots,), dtype=torch.bool, device=device),
        cache=init_kv_cache(dims, n_slots, total_len, dtype=kv_dtype or cache_dtype, device=device),
        cross_kv={
            "k": torch.zeros(cross_shape, dtype=cross_dtype, device=device),
            "v": torch.zeros(cross_shape, dtype=cross_dtype, device=device),
        },
    )


def _pick(logits, tokens, pos, sample_begin: int, logit_bias, rules) -> torch.Tensor:
    """Greedy pick with the reference tie-break (highest index)."""
    if logit_bias is not None:
        logits = logits + logit_bias
    if rules is not None:
        logits = rules.apply(logits, tokens, pos, sample_begin)
    return argmax_last(logits)


def prefill_pack(
    params: Params,
    enc_out: torch.Tensor,  # [B, n_audio_ctx, d]
    prompts: torch.Tensor,  # [B, P] int — fixed-length prompt template
    dims: ModelDims,
    eot: int,
    total_len: int,
    logit_bias: Optional[torch.Tensor] = None,
    rules: Optional[LogitRules] = None,
    compute_dtype: torch.dtype = torch.float32,
    kv_cache_dtype: Optional[torch.dtype] = None,
    cross_kv: Optional[KVCache] = None,  # shared with language detection
) -> SlotPack:
    """Encode-side half of admission: cross-KV + prompt prefill + first
    sampled token for a group of new utterances. The same steps as
    ``greedy_decode``'s prefill, so a continuous decode is token-identical
    to a static one."""
    b, p_len = prompts.shape
    device = enc_out.device
    prompts = prompts.to(device=device, dtype=torch.long)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, enc_out, dims, kv_dtype=kv_cache_dtype)
    cache = init_kv_cache(
        dims, b, total_len, dtype=kv_cache_dtype or compute_dtype, device=device
    )
    logits, cache = decoder_prefill(params, prompts, cache, cross_kv, dims, compute_dtype)
    tokens = torch.full((b, total_len), eot, dtype=torch.long, device=device)
    tokens[:, :p_len] = prompts
    first = _pick(logits[:, -1, :], tokens, p_len, p_len, logit_bias, rules)
    tokens[:, p_len] = first
    return SlotPack(
        tokens=tokens,
        pos=torch.full((b,), p_len + 1, dtype=torch.long, device=device),
        still_active=(first != eot) & (p_len + 1 < total_len),
        cache=cache,
        cross_kv=cross_kv,
    )


def _copy_row(dst: torch.Tensor, dst_idx: int, src: torch.Tensor, src_idx: int, axis: int) -> None:
    """dst[..., dst_idx, ...] = src[..., src_idx, ...] along ``axis``, byte
    for byte (both sides hold the same dtype)."""
    if src.dtype != dst.dtype:
        raise TypeError(f"slot copy from {src.dtype} into {dst.dtype}")
    dst.view(torch.uint8).select(axis, dst_idx).copy_(src.view(torch.uint8).select(axis, src_idx))


def insert_slot(state: SlotState, slot: int, pack: SlotPack, row: int) -> SlotState:
    """Insert row ``row`` of a SlotPack (on the state's device) at slot
    ``slot``, in place."""
    state.tokens[slot] = pack.tokens[row]
    state.pos[slot] = pack.pos[row]
    state.active[slot] = pack.still_active[row]
    for tree_dst, tree_src in ((state.cache, pack.cache), (state.cross_kv, pack.cross_kv)):
        for n in ("k", "v"):
            _copy_row(tree_dst[n], slot, tree_src[n], row, 1)
    return state


def pack_to(pack: SlotPack, device: torch.device | str) -> SlotPack:
    """The pack on ``device`` (a disaggregated encoder's pack crossing to
    the decode side): one transfer per pack, not per inserted row."""
    return SlotPack(
        tokens=pack.tokens.to(device),
        pos=pack.pos.to(device),
        still_active=pack.still_active.to(device),
        cache={n: x.to(device) for n, x in pack.cache.items()},
        cross_kv={n: x.to(device) for n, x in pack.cross_kv.items()},
    )


def decode_step_slots(
    params: Params,
    state: SlotState,
    dims: ModelDims,
    eot: int,
    sample_begin: int,
    logit_bias: Optional[torch.Tensor] = None,
    rules: Optional[LogitRules] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> SlotState:
    """Advance every active slot by one token, in place. Inactive slots
    still run the step (fixed shapes) and are frozen by masking: their
    cache writes land on dead positions and their token and position stay
    put. No value is read back to the host."""
    total_len = state.tokens.shape[1]
    rows = torch.arange(state.tokens.shape[0], device=state.tokens.device)
    # Clamp the read/write positions into range for every row (inactive
    # slots may sit at total_len).
    read_pos = torch.clamp(state.pos - 1, 0, total_len - 1)
    prev = state.tokens[rows, read_pos]
    logits, _ = decoder_step(
        params, prev, read_pos, state.cache, state.cross_kv, dims, compute_dtype
    )
    nxt = _pick(logits, state.tokens, state.pos, sample_begin, logit_bias, rules)
    write_pos = torch.clamp(state.pos, 0, total_len - 1)
    nxt = torch.where(state.active, nxt, state.tokens[rows, write_pos])
    state.tokens[rows, write_pos] = nxt
    state.pos.copy_(torch.where(state.active, state.pos + 1, state.pos))
    state.active.logical_and_((nxt != eot) & (state.pos < total_len))
    return state


def move_slot(state: SlotState, src: int, dst: int) -> SlotState:
    """Copy slot ``src`` onto ``dst`` and deactivate ``src``, in place: the
    compaction behind occupancy buckets (``engine/serving.py``), which keeps
    occupied slots in a prefix so that a step can run on a sub-pool."""
    for x in (state.tokens, state.pos, state.active):
        x[dst] = x[src]
    state.active[src] = False
    for tree in (state.cache, state.cross_kv):
        for n in ("k", "v"):
            _copy_row(tree[n], dst, tree[n], src, 1)
    return state


def slice_slots(state: SlotState, n: int) -> SlotState:
    """The first ``n`` slots as views: a step on them writes the full
    state, so :func:`merge_slots` has nothing to copy back."""
    return SlotState(
        tokens=state.tokens[:n],
        pos=state.pos[:n],
        active=state.active[:n],
        cache={k: v[:, :n] for k, v in state.cache.items()},
        cross_kv={k: v[:, :n] for k, v in state.cross_kv.items()},
    )


def merge_slots(state: SlotState, sub: SlotState) -> SlotState:
    """Write a stepped prefix sub-pool back into the full state. A
    sub-pool from :func:`slice_slots` shares its storage, so only one that
    does not is copied. ``cross_kv`` is read-only in the step and is
    never copied back."""
    n = sub.tokens.shape[0]
    for dst, src in ((state.tokens, sub.tokens), (state.pos, sub.pos), (state.active, sub.active)):
        if src.data_ptr() != dst.data_ptr():
            dst[:n] = src
    for name in ("k", "v"):
        dst, src = state.cache[name], sub.cache[name]
        if src.data_ptr() != dst.data_ptr():
            dst.view(torch.uint8)[:, :n] = src.view(torch.uint8)
    return state


def harvest_lengths(tokens: torch.Tensor, p_len: int, eot: int) -> torch.Tensor:
    """Valid-token count per slot incl. the terminating EOT (greedy_decode's
    length rule)."""
    after = tokens[:, p_len:] == eot
    any_eot = after.any(dim=1)
    first_eot = torch.argmax(after.to(torch.int8), dim=1)
    return torch.where(any_eot, p_len + first_eot + 1, tokens.shape[1])
