"""Neural net building blocks as plain functions over parameter dicts.

Counterpart of ``whisper_tpu/models/layers.py``, with its layouts:

  linear:    {"w": [d_in, d_out], "b": [d_out]}     (b optional — whisper's
              attention K projection is bias-free)
  layernorm: {"g": [d], "b": [d]}
  conv1d:    {"w": [c_out, c_in, width], "b": [c_out]}  (torch layout; the
              JAX tree's HIO weight is transposed by params.params_from_jax)

Numerics against JAX, which accumulates every product in f32
(``preferred_element_type``) and adds biases in f32 before one cast:

* float32: the same arithmetic; only the order of sums differs.
* bfloat16: a bf16 ``torch.matmul`` accumulates in f32 but rounds its
  product to bf16 before the bias is added in f32, so ``linear`` and
  ``conv1d`` round twice where JAX rounds once — at most one extra bf16
  rounding (2^-8 relative) per output. The attention score products are
  taken on f32 copies of q and k, so scores are f32 as in JAX.

Int8 weights (``{"w_q": int8, "w_s": f32 per output channel}``, see
``models/quantize.py``): ``w_q`` is cast to the activation dtype, multiplied
with ``torch.matmul`` and the f32 product is rescaled per output channel
before the bias, as in JAX. In f32 that is JAX's arithmetic; in bf16 the
product is rounded to bf16 before the f32 rescale (one extra bf16 rounding
per output, the same class as the float weights above). The int8 embedding
table ``{"q", "s"}`` is per-row scaled, in f32. fp8 K/V (``itemsize == 1``,
``kv_cache_dtype="float8_e4m3fn"``) give the query's dtype, as in JAX: the
self-attention's are upcast to it at use (``qkv_attention``); the cross
K/V's are upcast in registers by the cross-attention kernel on the card
(``ops/cross_attend``, bf16 queries) and to the query's dtype at use
elsewhere (its plain version: f32 queries, the CPU).

Tensor parallelism (``tp``: this rank's ``parallel.mesh.Mesh``, or None):
the parameters are this rank's slices (``parallel/sharding.py``). A
row-parallel ``linear`` (the o projections, fc2) forms its partial product
from f32 operands and all-reduces it over the model group, before the int8
rescale, the bias and the cast, where GSPMD sums JAX's f32 einsum result
(in bf16 one rounding per output, as in JAX, where one process rounds
twice); ``embed`` gathers the group's feature slices; ``unembed``
contracts this rank's feature slice and all-reduces the f32 partial
logits. Each collective is a no-op without a model axis
(``parallel/collectives.py``). Head counts passed to the attention
functions are this rank's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from whisper_tpu_torch.ops import cross_attend
from whisper_tpu_torch.parallel.collectives import all_gather_model, all_reduce_model, model_size


def linear(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x @ w (+ b), in the activation dtype. Mixed float dtypes (a bf16
    attention output against f32 weights) multiply in the promoted dtype,
    as JAX's einsum does, and the result returns to ``x.dtype``. ``tp``: a
    row-parallel weight, whose partial product is formed from f32 operands
    (exact products of bf16 or int8 values, summed in f32: no bf16 rounding
    before the sum) and summed over the model group before the rescale and
    the bias."""
    w = p["w_q"] if "w_q" in p else p["w"]
    dt = torch.float32 if model_size(tp) > 1 else torch.promote_types(x.dtype, w.dtype)
    y = all_reduce_model(torch.matmul(x.to(dt), w.to(dt)).float(), tp)
    if "w_q" in p:
        y = y * p["w_s"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # Always normalize in f32, with the population variance (jnp.var).
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # Exact (erf) GELU, not the tanh approximation.
    return F.gelu(x, approximate="none")


def conv1d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """[B, T, C_in] → [B, T', C_out], padding (width-1)//2 each side."""
    w = p["w_q"] if "w_q" in p else p["w"]
    pad = (w.shape[-1] - 1) // 2
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), stride=stride, padding=pad)
    y = y.transpose(1, 2).float()
    if "w_q" in p:
        y = y * p["w_s"].float()  # per-c_out int8 rescale
    return (y + p["b"].float()).to(x.dtype)


def embed(tok_emb, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token-embedding lookup, float or int8 table ({"q","s"} per-row; f32).
    ``tp``: the table is this rank's feature slice, and the model group's
    slices are gathered to the whole width."""
    if isinstance(tok_emb, dict):
        rows = tok_emb["q"][tokens].float() * tok_emb["s"][tokens][..., None].float()
    else:
        rows = tok_emb[tokens]
    return all_gather_model(rows, tp, dim=-1)


def unembed(tok_emb, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits projection against the (possibly int8) embedding table:
    [..., d] → [..., V] f32. ``tp``: the table is this rank's feature
    slice; ``x``'s matching slice is contracted with it and the f32 partial
    logits are summed over the model group before the int8 row scale."""
    table = tok_emb["q"] if isinstance(tok_emb, dict) else tok_emb
    w = table.shape[1]
    if w != x.shape[-1]:
        x = x[..., tp.model_index * w : (tp.model_index + 1) * w]
    logits = all_reduce_model(torch.matmul(x.float(), table.float().t()), tp)
    if isinstance(tok_emb, dict):
        logits = logits * tok_emb["s"].float()
    return logits


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, d] → [B, T, H, Dh]."""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def qkv_attention(
    q: torch.Tensor,  # [B, Tq, H, Dh]
    k: torch.Tensor,  # [B, Tk, H, Dh]
    v: torch.Tensor,  # [B, Tk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk]
) -> torch.Tensor:
    """Scaled dot-product attention: f32 scores times 1/sqrt(Dh), f32
    softmax, weights cast to ``v.dtype`` for the value product. Returns
    [B, Tq, H, Dh] in ``v.dtype`` (the query's dtype for an fp8 cache,
    which is upcast at use)."""
    if k.element_size() == 1:
        k = k.to(q.dtype)
    if v.element_size() == 1:
        v = v.to(q.dtype)
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / float(dh) ** 0.5)
    if mask is not None:
        scores = scores + mask.float()
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return out.to(v.dtype)


def cross_attention_T(
    q: torch.Tensor,  # [B, Tq, H, Dh]
    kT: torch.Tensor,  # [B, H, Dh, Tk]
    vT: torch.Tensor,  # [B, H, Dh, Tk]
) -> torch.Tensor:
    """Unmasked cross-attention against head-major, sequence-minor K/V (the
    layout ``decoder.precompute_cross_kv`` stores). A CUDA call with a bf16
    query goes to the hand-written kernel (``ops/cross_attend``), which
    reads the stored K/V once, upcasts fp8 in registers, and raises on a
    head size or store it does not take; the float32 parity dtype and CPU
    tensors take its plain version (fp8 K/V upcast to the query's dtype at
    use). Returns [B, Tq, H, Dh]."""
    if q.device.type == "cuda" and cross_attend.routes(q):
        return cross_attend.cross_attend(q, kT, vT)
    return cross_attend.cross_attend_reference(q, kT, vT)


def mha_self(p, x: torch.Tensor, n_head: int, mask=None, fused: bool = False, tp=None):
    """Full (non-cached) multi-head self-attention block body over
    ``n_head`` heads (this rank's under ``tp``, where the o projection is
    row-parallel).

    ``fused=True`` with no mask goes through K1 (``ops.attention``): the
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor."""
    q = split_heads(linear(p["q"], x), n_head)
    k = split_heads(linear(p["k"], x), n_head)
    v = split_heads(linear(p["v"], x), n_head)
    if fused and mask is None:
        from whisper_tpu_torch.ops.attention import fused_self_attention

        o = fused_self_attention(q, k, v)
    else:
        o = qkv_attention(q, k, v, mask)
    return linear(p["o"], merge_heads(o), tp=tp)


def mlp(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """fc1 (column-parallel under ``tp``), GELU, fc2 (row-parallel)."""
    return linear(p["fc2"], gelu(linear(p["fc1"], x)), tp=tp)
