"""Word-level timestamps: DTW over cross-attention alignment.

Counterpart of ``whisper_tpu/decode/align.py`` (openai-whisper
``timing.py``'s recipe):

1. a teacher-forced alignment forward over the final token rows
   (:func:`alignment_matrix`, on the device): each layer's cross-attention
   weights, z-normalised per head over the token axis, averaged over the
   selected alignment heads. One layer's ``[B, H, T, Ta]`` f32 weights
   are alive at a time; only the ``[B, T, Ta]`` head average leaves the
   loop;
2. on the host, in numpy (the port's own copies of JAX's helpers): a median
   filter along the audio axis and a dynamic-time-warping pass over the
   negative matrix (:func:`dtw_path`, a pure-Python double loop, as in
   JAX);
3. token → word grouping on byte surfaces (a new word starts on a leading
   space), frame indices mapped to seconds (one encoder position = 20 ms).

Alignment heads: openai ships a per-checkpoint head mask; without one, all
heads of the upper half of the decoder stack.

Under tensor parallelism a rank holds ``n_text_head / m`` heads: it takes
the mask's columns for its own heads, sums its part of the selected heads'
z-normed weights, and the sum is all-reduced over the model group before
the division by the global count of selected heads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.decoder import KVCache
from whisper_tpu_torch.models.params import Params
from whisper_tpu_torch.parallel import collectives
from whisper_tpu_torch.parallel.collectives import all_reduce_model, local_heads

# One encoder position covers two 10 ms mel hops (conv stem stride 2).
SECONDS_PER_POSITION = 0.02

NEG_INF = -1e30


@dataclass
class Word:
    word: str
    start: float  # seconds into the 30 s window
    end: float
    tokens: List[int]


def default_alignment_mask(dims: ModelDims) -> np.ndarray:
    """[L, H] bool — upper half of the decoder stack, all heads."""
    mask = np.zeros((dims.n_text_layer, dims.n_text_head), bool)
    mask[dims.n_text_layer // 2 :, :] = True
    return mask


def heads_to_mask(heads: Sequence[Tuple[int, int]], dims: ModelDims) -> np.ndarray:
    mask = np.zeros((dims.n_text_layer, dims.n_text_head), bool)
    for l, h in heads:
        mask[l, h] = True
    return mask


@collectives.stage("align")
def alignment_matrix(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int — the FULL decoded rows (prompt incl.)
    cross_kv: KVCache,  # head-major [L, B, H, Dh, Ta], any storage dtype
    dims: ModelDims,
    head_mask: np.ndarray,  # [L, H] bool, over the model's global heads
    compute_dtype: torch.dtype = torch.float32,
    tp=None,  # this rank's mesh: cross_kv and the weights hold its heads
) -> torch.Tensor:
    """Teacher-forced forward → head-averaged, z-normed cross-attention
    alignment matrix [B, T, Ta] float32 (openai ``find_alignment``).

    The weights are the decoder's cross-attention softmax probabilities
    (f32 scores, as the decode's); per selected head they are standardised
    over the token axis, ``(w - mean) / (std + 1e-9)`` with the population
    std, then averaged. Self-attention is plain causal attention over the
    whole sequence (no KV cache). Layers with no selected head add nothing
    to the average (JAX adds their zero-weighted sum) and skip the
    z-norm."""
    head_mask = np.asarray(head_mask, bool)
    n_sel = max(float(head_mask.sum()), 1.0)
    dec = params["decoder"]
    n_head = local_heads(dims.n_text_head, tp)
    if tp is not None:  # this rank's heads: global columns [i · n_head, (i + 1) · n_head)
        head_mask = head_mask[:, tp.model_index * n_head : (tp.model_index + 1) * n_head]
    b, t = tokens.shape
    dh = dims.n_text_state // dims.n_text_head
    device = tokens.device
    tokens = tokens.to(torch.long)

    h = (layers.embed(dec["tok_emb"], tokens, tp) + dec["pos_emb"][:t]).to(compute_dtype)
    pos = torch.arange(t, device=device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG_INF).to(compute_dtype)
    ta = cross_kv["k"].shape[-1]
    acc = torch.zeros((b, t, ta), dtype=torch.float32, device=device)

    for layer, bp in enumerate(dec["blocks"]):
        hn = layers.layer_norm(bp["ln1"], h)
        q, k, v = (layers.split_heads(layers.linear(bp["attn"][n], hn), n_head) for n in "qkv")
        attn = layers.qkv_attention(q, k, v, causal)
        h = h + layers.linear(bp["attn"]["o"], layers.merge_heads(attn), tp=tp)

        hn = layers.layer_norm(bp["ln2"], h)
        qx = layers.split_heads(layers.linear(bp["cross"]["q"], hn), n_head)
        kT, vT = cross_kv["k"][layer], cross_kv["v"][layer]  # [B, H, Dh, Ta]
        if kT.element_size() == 1:
            kT = kT.to(qx.dtype)
        if vT.element_size() == 1:
            vT = vT.to(qx.dtype)
        scores = torch.matmul(qx.transpose(1, 2).float(), kT.float()) * (1.0 / float(dh) ** 0.5)
        w = torch.softmax(scores, dim=-1)  # [B, H, T, Ta] f32
        del scores
        if head_mask[layer].any():
            # z-norm per head over the TOKEN axis (openai timing.py
            # std_mean dim=-2, population std as jnp.std), selected heads
            # summed.
            std, mean = torch.std_mean(w, dim=2, keepdim=True, correction=0)
            sel = torch.from_numpy(head_mask[layer].astype(np.float32)).to(device)
            acc += torch.einsum("bhqk,h->bqk", (w - mean) / (std + 1e-9), sel)
        out = torch.matmul(w.to(vT.dtype), vT.transpose(-1, -2))  # [B, H, T, Dh]
        del w
        out = layers.merge_heads(out.transpose(1, 2).to(h.dtype))
        h = h + layers.linear(bp["cross"]["o"], out, tp=tp)
        h = h + layers.mlp(bp["mlp"], layers.layer_norm(bp["ln3"], h), tp=tp)
    acc = all_reduce_model(acc, tp)
    return acc / torch.full_like(acc, n_sel)  # a device divisor: see models/quantize.py


def median_filter(matrix: np.ndarray, width: int = 7) -> np.ndarray:
    """Median over a sliding window along the last (audio) axis, edges
    padded by reflection — openai timing.py's medfilt."""
    if width <= 1:
        return matrix
    pad = width // 2
    padded = np.pad(matrix, [(0, 0)] * (matrix.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost [T_text, T_audio] → (text_idx, time_idx)
    path, both non-decreasing, covering every text row. Classic O(N·M) DP
    with steps (−1,−1), (−1,0), (0,−1) (openai timing.py dtw)."""
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for i in range(1, n + 1):
        row_c = cost[i - 1]
        for j in range(1, m + 1):
            c0 = D[i - 1, j - 1]
            c1 = D[i - 1, j]
            c2 = D[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                D[i, j] = c0 + row_c[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                D[i, j] = c1 + row_c[j - 1]
                trace[i, j] = 1
            else:
                D[i, j] = c2 + row_c[j - 1]
                trace[i, j] = 2
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        step = trace[i, j]
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


def token_boundaries(text_idx: np.ndarray, time_idx: np.ndarray, n_tokens: int) -> np.ndarray:
    """Per-token (start_frame, end_frame): first/last audio index the DTW
    path assigns to each text row."""
    bounds = np.zeros((n_tokens, 2), np.int64)
    for tok in range(n_tokens):
        sel = time_idx[text_idx == tok]
        if len(sel):
            bounds[tok] = sel[0], sel[-1] + 1
        elif tok > 0:
            bounds[tok] = bounds[tok - 1, 1], bounds[tok - 1, 1]
    return bounds


def split_words(vocab, token_ids: Sequence[int]) -> List[Tuple[str, List[int]]]:
    """Group text tokens into words on byte surfaces: a token whose surface
    starts with a space (or that begins the stream) starts a new word.
    Special tokens are skipped (they carry no surface time)."""
    eot = vocab.specials.eot
    words: List[Tuple[bytearray, List[int]]] = []
    for pos, tid in enumerate(token_ids):
        tid = int(tid)
        if tid >= eot:
            continue
        surface = vocab.surface(tid)
        if not words or surface.startswith(b" "):
            words.append((bytearray(surface), [pos]))
        else:
            words[-1][0].extend(surface)
            words[-1][1].append(pos)
    return [
        (buf.decode("utf-8", errors="replace").strip(), idxs)
        for buf, idxs in words
        if buf.strip()
    ]


def words_from_alignment(
    vocab,
    tokens: np.ndarray,  # [total_len] int32, prompt included
    length: int,
    p_len: int,
    matrix: np.ndarray,  # [T, Ta] raw alignment (tokens axis = full row)
    n_frames: Optional[int] = None,  # valid encoder positions (None = all)
    medfilt_width: int = 7,
) -> List[Word]:
    """Full host-side pipeline: trim → filter → DTW → token bounds → words."""
    gen = np.asarray(tokens[p_len:length], dtype=np.int64)
    if gen.size == 0:
        return []
    sub = matrix[p_len:length]
    if n_frames is not None:
        sub = sub[:, : max(int(n_frames), 2)]
    sub = median_filter(sub, medfilt_width)
    text_idx, time_idx = dtw_path(-sub.astype(np.float64))
    bounds = token_boundaries(text_idx, time_idx, len(gen))
    out: List[Word] = []
    for word, idxs in split_words(vocab, gen):
        start = bounds[idxs[0], 0] * SECONDS_PER_POSITION
        end = bounds[idxs[-1], 1] * SECONDS_PER_POSITION
        out.append(
            Word(word=word, start=float(start), end=float(end), tokens=[int(gen[i]) for i in idxs])
        )
    return out
