"""An audio language model: a Whisper encoder, a pool and a linear
projector, then a decoder-only mixture-of-experts language model
(``config.AudioLMDims``; Uni-MoE-2.0-Omni's audio-to-text path).

Parameters (plain nested dicts, linear weights ``[d_in, d_out]`` as in
``models/params.py``):

* ``tower``: ``{"encoder": ...}``, the Whisper encoder tree of
  ``models/params.py`` at ``dims.tower``;
* ``projector``: ``{"w": [d_tower, D], "b": [D]}``;
* ``embed``: [V, D]; ``norm``: [D]; ``head``: [D, V] (untied);
* ``blocks``: one dict a layer: ``attn_norm`` [D]; ``attn`` with ``q``,
  ``k``, ``v`` (``{"w", "b"}``: H·Dh, KV·Dh and KV·Dh outputs) and ``o``
  (``{"w"}``, no bias); ``moe_norm`` [D]; ``gate`` [D, E + Z] float32 (the
  E routed experts' columns, then the Z null experts'); ``shared``: the S
  shared experts side by side, ``w_gate`` and ``w_up`` [D, S·Fs],
  ``w_down`` [S·Fs, D] (expert s holds the columns, or rows, [s·Fs,
  (s+1)·Fs), so their sum is one SwiGLU of width S·Fs); ``experts``:
  ``w_gate`` and ``w_up`` [E, D, F], ``w_down`` [E, F, D].

The equations (each choice the published config leaves open is one the
benchmark's configuration file lists under ``assumed``):

* RMSNorm in float32, ``x · rsqrt(mean(x²) + eps) · g``, before the
  attention and before the MoE of every layer, and once at the end;
* attention: q, k, v with biases, o without; GQA (each KV head serves
  H / KV query heads); rotate-half RoPE at ``rope_theta`` on the whole
  head; scores and softmax in float32; causal over a row's own positions;
* MoE: ``y = Σ_s E_s(x) + Σ_{e chosen} p_e · E_e(x)``, each expert a
  SwiGLU ``(silu(x W_gate) ⊙ x W_up) W_down``; the gate ``p =
  softmax(x W_g)`` in float32 over the routed and null experts, sorted
  down; the fewest whose sum reaches ``top_p``, at most ``top_k``; the
  chosen weights are not renormalised; a chosen null expert adds 0;
* audio: the tower's first ``audio_ctx`` positions, mean-pooled in groups
  of ``pool``, through the projector.

Rows are left-padded to the longest prefix of the batch
(:func:`prefix_layout`), so every row's next position is at one cache
index; each row has its own RoPE positions and its own mask. Pad positions
route to no expert.

Given ``routes``, the prefill and each step also write the routing of
every position (:func:`route_codes`), so that a judge can hold the
program's routing against another's. The routing counters
(:func:`new_counters`) stay on the device: int64
[2, E + Z + 3], a row for the prefill and one for the decode step, each
the picks of every expert (routed, then null), the routed rows, the
experts touched (summed over calls) and the calls. They are updated by
tensor operations only, so a captured decode step counts on every replay.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.config import AudioLMDims
from whisper_tpu_torch.models.layers import linear
from whisper_tpu_torch.models.params import Params, init_params
from whisper_tpu_torch.ops.moe_expert import moe_experts

PREFILL, STEP = 0, 1  # the rows of the routing counters


# --- parameters ---------------------------------------------------------------
def init_lm_params(dims: AudioLMDims, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32, device="cpu") -> Params:
    """Random parameters of the layout above, drawn on ``device`` from
    ``generator``: matrices ``fan_in^-0.5``, norm gains ``1 + 0.1·n``,
    biases ``0.02·n`` (the tower's as ``models/params.init_params`` draws
    them)."""

    def normal(shape, std, dt=dtype):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dt)

    def gain(n):
        return (1.0 + normal((n,), 0.1, torch.float32)).to(dtype)

    d, h, kv, dh = dims.n_state, dims.n_head, dims.n_kv_head, dims.head_dim
    e, f = dims.n_routed, dims.routed_width
    sf = dims.n_shared * dims.shared_width
    tower = init_params(dims.tower, generator, dtype=dtype, device=device)["encoder"]

    def dense(d_in, d_out, bias=True):
        p = {"w": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = normal((d_out,), 0.02)
        return p

    blocks = []
    for _ in range(dims.n_layer):
        blocks.append({
            "attn_norm": gain(d),
            "attn": {"q": dense(d, h * dh), "k": dense(d, kv * dh), "v": dense(d, kv * dh),
                     "o": dense(h * dh, d, bias=False)},
            "moe_norm": gain(d),
            "gate": normal((d, e + dims.n_null), d ** -0.5, torch.float32),
            "shared": {"w_gate": normal((d, sf), d ** -0.5), "w_up": normal((d, sf), d ** -0.5),
                       "w_down": normal((sf, d), dims.shared_width ** -0.5)},
            "experts": {"w_gate": normal((e, d, f), d ** -0.5),
                        "w_up": normal((e, d, f), d ** -0.5),
                        "w_down": normal((e, f, d), f ** -0.5)},
        })
    return {
        "tower": {"encoder": tower},
        "projector": dense(dims.tower.n_audio_state, d),
        "embed": normal((dims.n_vocab, d), 1.0),
        "blocks": blocks,
        "norm": gain(d),
        "head": normal((d, dims.n_vocab), d ** -0.5),
    }


# --- the prefix ---------------------------------------------------------------
def audio_positions(n_samples: int, dims: AudioLMDims) -> int:
    """LM positions of a clip of ``n_samples`` at 16 kHz: one per ``pool``
    tower positions of 320 samples, at least 1, at most what
    ``audio_ctx`` holds."""
    return int(min(max(n_samples // (320 * dims.pool), 1), dims.audio_ctx // dims.pool))


def prefix_layout(n_audio: np.ndarray, n_prefix: int, n_suffix: int, n_pool: int) -> dict:
    """Host-side layout of a batch's left-padded prefixes: for each row,
    ``n_prefix`` text ids, its ``n_audio[i]`` audio positions, ``n_suffix``
    text ids, right-aligned at the longest prefix ``P``. Returns ``src``
    [B, P] (an index into ``cat([text embeddings (prefix then suffix),
    the batch's projected audio [B·n_pool], a zero row])``), ``pad`` [B]
    (the row's left padding) and ``P``."""
    n_audio = np.asarray(n_audio, np.int64)
    b = len(n_audio)
    lens = n_prefix + n_audio + n_suffix
    p = int(lens.max())
    n_text = n_prefix + n_suffix
    zero = n_text + b * n_pool
    src = np.full((b, p), zero, np.int64)
    for i in range(b):
        row = np.concatenate([
            np.arange(n_prefix),
            n_text + i * n_pool + np.arange(n_audio[i]),
            n_prefix + np.arange(n_suffix),
        ])
        src[i, p - lens[i]:] = row
    return {"src": src, "pad": (p - lens).astype(np.int64), "P": p}


def project(params: Params, enc_out: torch.Tensor, dims: AudioLMDims) -> torch.Tensor:
    """Tower output [B, ≥ audio_ctx, d_tower] → [B, audio_ctx / pool, D]:
    the first ``audio_ctx`` positions mean-pooled in groups of ``pool``
    (in float32), then the linear projector."""
    b = enc_out.shape[0]
    x = enc_out[:, : dims.audio_ctx].float()
    pooled = x.reshape(b, dims.audio_ctx // dims.pool, dims.pool, -1).mean(2)
    return linear(params["projector"], pooled.to(enc_out.dtype))


def embed_prefix(params: Params, audio: torch.Tensor, text_ids: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """The prefix embeddings [B, P, D]: ``src`` (of :func:`prefix_layout`,
    on the device) into the text ids' embeddings, ``audio`` [B, n, D]
    flattened, and a zero row."""
    d = audio.shape[-1]
    table = torch.cat([params["embed"][text_ids].to(audio.dtype), audio.reshape(-1, d),
                       audio.new_zeros((1, d))])
    return table[src]


# --- layers -------------------------------------------------------------------
def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * g.float()).to(x.dtype)


def rope_tables(pos: torch.Tensor, dh: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [B, T, 1, Dh/2] of RoPE's angles at positions ``pos``
    [B, T], in float32 (made once a forward, for every layer)."""
    exps = torch.arange(0, dh, 2, dtype=torch.float64, device=pos.device) / dh
    inv = torch.pow(torch.full_like(exps, theta), -exps).float()  # on the device: no copy
    ang = pos.float()[..., None] * inv  # [B, T, Dh/2]
    return torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]


def rope(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotate-half RoPE on [B, T, heads, Dh], in float32."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """GQA: q [B, T, H, Dh] against k, v [B, KV, Tk, Dh] under an additive
    float32 ``mask`` broadcastable to [B, 1, 1, T, Tk] → [B, T, H·Dh]."""
    b, t, h, dh = q.shape
    kv = k.shape[1]
    g = h // kv
    # A KV head's G query heads as G·T rows of one product: no copy of K or V.
    qg = q.view(b, t, kv, g, dh).permute(0, 2, 3, 1, 4).reshape(b, kv, g * t, dh)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    w = torch.softmax(s.view(b, kv, g, t, -1) + mask, dim=-1).to(v.dtype)
    o = torch.matmul(w.view(b, kv, g * t, -1), v)  # [B, KV, G·T, Dh]
    return o.view(b, kv, g, t, dh).permute(0, 3, 1, 2, 4).reshape(b, t, h * dh)


def route(gate: torch.Tensor, h: torch.Tensor, dims: AudioLMDims,
          valid: Optional[torch.Tensor] = None):
    """The gate on normed rows ``h`` [N, D]: ``p = softmax(h W_g)`` in
    float32; the top ``top_k`` sorted down, slot j taken while the slots
    before it sum below ``top_p``. Returns (expert [N, K]: the routed
    expert, or E where the slot is not taken or picks a null expert;
    weight [N, K] float32: its probability, 0 there; picked [N, K] bool:
    the slot is taken; idx [N, K]: the expert of each slot)."""
    probs = torch.softmax(h.float() @ gate.float(), dim=-1)
    top, idx = torch.topk(probs, dims.top_k, dim=-1)
    picked = (top.cumsum(-1) - top) < dims.top_p
    if valid is not None:
        picked = picked & valid[:, None]
    routed = picked & (idx < dims.n_routed)
    expert = torch.where(routed, idx, dims.n_routed)
    weight = torch.where(routed, top, torch.zeros_like(top))
    return expert, weight, picked, idx


def moe(bp: dict, h: torch.Tensor, dims: AudioLMDims, valid: Optional[torch.Tensor] = None,
        tally: Optional[list] = None) -> torch.Tensor:
    """The MoE of one layer on normed rows ``h`` [N, D] → float32 [N, D]:
    the shared experts (one SwiGLU over their side-by-side widths) plus the
    routed experts (``ops/moe_expert``). Its routing is appended to
    ``tally``, which :func:`count` adds to the counters once a forward."""
    s = bp["shared"]
    act = F.silu(torch.matmul(h, s["w_gate"]).float()) * torch.matmul(h, s["w_up"]).float()
    y = torch.matmul(act.to(h.dtype), s["w_down"]).float()
    expert, weight, picked, idx = route(bp["gate"], h, dims, valid)
    ex = bp["experts"]
    yr, counts = moe_experts(h, expert, weight, ex["w_gate"], ex["w_up"], ex["w_down"])
    if tally is not None:
        tally.append((idx, picked, counts))
    return y + yr


def count(counters: torch.Tensor, phase: int, tally: list, dims: AudioLMDims) -> None:
    """Add the routing of ``tally`` (one (expert of each slot, slot taken,
    rows of each routed expert) a call) to ``counters[phase]``."""
    n_gate = dims.n_routed + dims.n_null
    idx = torch.stack([t[0] for t in tally])
    picked = torch.stack([t[1] for t in tally])
    counts = torch.stack([t[2] for t in tally])
    picks = torch.zeros(n_gate, dtype=torch.int64, device=idx.device)
    picks.index_add_(0, idx.reshape(-1), picked.reshape(-1).long())
    row = counters[phase]
    row[:n_gate].add_(picks)
    row[n_gate].add_(counts.sum())
    row[n_gate + 1].add_((counts > 0).sum())
    row[n_gate + 2].add_(len(tally))


def route_codes(tally: list) -> torch.Tensor:
    """The routing of a forward's calls, one a layer: int8 [L, N, K], each
    slot's gate output (routed experts, then null ones) where the slot is
    taken, -1 where it is not."""
    idx = torch.stack([t[0] for t in tally])
    picked = torch.stack([t[1] for t in tally])
    return torch.where(picked, idx, -1).to(torch.int8)


# The routing counted in this process, read back by the engines once a
# batch: {"prefill": ..., "step": ...}, each as :func:`counters_dict`.
routing: Dict[str, Dict[str, object]] = {}


def add_routing(delta: np.ndarray, dims: AudioLMDims) -> None:
    """Add the growth ``delta`` of an engine's counters to :data:`routing`."""
    for phase, name in ((PREFILL, "prefill"), (STEP, "step")):
        got = counters_dict(delta[phase], dims)
        acc = routing.setdefault(name, {k: [0] * len(v) if isinstance(v, list) else 0
                                        for k, v in got.items()})
        for k, v in got.items():
            acc[k] = [a + c for a, c in zip(acc[k], v)] if isinstance(v, list) else acc[k] + v


def new_counters(dims: AudioLMDims, device) -> torch.Tensor:
    return torch.zeros((2, dims.n_routed + dims.n_null + 3), dtype=torch.int64, device=device)


def counters_dict(row: np.ndarray, dims: AudioLMDims) -> Dict[str, object]:
    """One row of the routing counters on the host, by name."""
    n_gate = dims.n_routed + dims.n_null
    return {"picks": [int(v) for v in row[:n_gate]],
            "null_picks": int(row[dims.n_routed:n_gate].sum()), "rows": int(row[n_gate]),
            "touched": int(row[n_gate + 1]), "calls": int(row[n_gate + 2])}


def _block(bp, x, tables, mask, kc, vc, write, dims, valid, tally):
    """One layer on rows ``x`` [B, T, D]: attention over the cache planes
    ``kc``, ``vc`` [B, KV, Tk, Dh] after ``write(k, v)`` stores this call's
    keys and values, then the MoE."""
    b, t, d = x.shape
    a = bp["attn"]
    hn = rms_norm(bp["attn_norm"], x, dims.norm_eps)
    q = rope(linear(a["q"], hn).view(b, t, dims.n_head, dims.head_dim), tables)
    k = rope(linear(a["k"], hn).view(b, t, dims.n_kv_head, dims.head_dim), tables)
    v = linear(a["v"], hn).view(b, t, dims.n_kv_head, dims.head_dim)
    write(k.transpose(1, 2), v.transpose(1, 2))
    x = x + linear(a["o"], attend(q, kc, vc, mask))
    hn = rms_norm(bp["moe_norm"], x, dims.norm_eps).reshape(b * t, d)
    y = moe(bp, hn, dims, None if valid is None else valid.reshape(-1), tally)
    return (x.float() + y.view(b, t, d)).to(x.dtype)


def head(params: Params, x: torch.Tensor, dims: AudioLMDims) -> torch.Tensor:
    """Final RMSNorm and the untied head: [B, D] → float32 logits [B, V]."""
    return torch.matmul(rms_norm(params["norm"], x, dims.norm_eps), params["head"]).float()


def init_cache(dims: AudioLMDims, b: int, total: int, dtype, device) -> Dict[str, torch.Tensor]:
    shape = (dims.n_layer, b, dims.n_kv_head, total, dims.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}


def prefill_mask(pad: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For left paddings ``pad`` [B]: RoPE positions [B, P], the additive
    mask [B, 1, 1, P, P] (a row's own positions, causal; a pad position
    sees itself only, so that no softmax is empty) and the valid positions
    [B, P]."""
    i = torch.arange(p, device=pad.device)
    valid = i[None, :] >= pad[:, None]
    keep = (i[None, :, None] >= i[None, None, :]) & valid[:, None, :]
    keep = keep | torch.eye(p, dtype=torch.bool, device=pad.device)[None]
    mask = torch.zeros(keep.shape, dtype=torch.float32, device=pad.device)
    mask = mask.masked_fill(~keep, float("-inf"))[:, None, None]
    return (i[None, :] - pad[:, None]).clamp(min=0), mask, valid


def prefill(params: Params, x: torch.Tensor, pad: torch.Tensor, cache: Dict[str, torch.Tensor],
            dims: AudioLMDims, counters: Optional[torch.Tensor] = None,
            routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prefix embeddings ``x`` [B, P, D] (left-padded by ``pad`` [B])
    through every layer, their keys and values into ``cache`` positions
    [0, P) → logits [B, V] at the last position. ``routes`` (int8 [L, B,
    P, K]) receives every position's :func:`route_codes`."""
    p = x.shape[1]
    pos, mask, valid = prefill_mask(pad, p)
    tables = rope_tables(pos, dims.head_dim, dims.rope_theta)
    tally: list = []
    for li, bp in enumerate(params["blocks"]):
        kc, vc = cache["k"][li], cache["v"][li]

        def write(k, v, kc=kc, vc=vc):
            kc[:, :, :p].copy_(k)
            vc[:, :, :p].copy_(v)

        x = _block(bp, x, tables, mask, kc[:, :, :p], vc[:, :, :p], write, dims, valid, tally)
    if counters is not None:
        count(counters, PREFILL, tally, dims)
    if routes is not None:
        routes.copy_(route_codes(tally).view(routes.shape))
    return head(params, x[:, -1], dims)


def step(params: Params, tok: torch.Tensor, at: torch.Tensor, pad: torch.Tensor,
         cache: Dict[str, torch.Tensor], window: int, dims: AudioLMDims,
         counters: Optional[torch.Tensor] = None, routes: Optional[torch.Tensor] = None,
         fed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token a row: ``tok`` [B] at cache index ``at`` (a one-element
    int64 tensor, the same for every row) → logits [B, V]; the cache's
    first ``window`` positions are read, those of a row's padding and past
    ``at`` masked. Reads every position from the device. ``routes`` (int8
    [L, B, G, K]) receives the step's :func:`route_codes` at index ``fed``
    (a one-element int64 tensor: the generated index of the token fed)."""
    x = params["embed"][tok][:, None]
    j = torch.arange(window, device=tok.device)
    keep = (j[None, :] >= pad[:, None]) & (j[None, :] <= at)
    mask = torch.zeros(keep.shape, dtype=torch.float32, device=tok.device)
    mask = mask.masked_fill(~keep, float("-inf"))[:, None, None, None]  # [B, 1, 1, 1, w]
    tables = rope_tables((at - pad)[:, None], dims.head_dim, dims.rope_theta)
    tally: list = []
    for li, bp in enumerate(params["blocks"]):
        kc, vc = cache["k"][li], cache["v"][li]

        def write(k, v, kc=kc, vc=vc):
            kc.index_copy_(2, at, k)
            vc.index_copy_(2, at, v)

        x = _block(bp, x, tables, mask, kc[:, :, :window], vc[:, :, :window], write, dims, None,
                   tally)
    if counters is not None:
        count(counters, STEP, tally, dims)
    if routes is not None:
        routes.index_copy_(2, fed, route_codes(tally)[:, :, None])
    return head(params, x[:, 0], dims)
