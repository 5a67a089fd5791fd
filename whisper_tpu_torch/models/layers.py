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

The int8 (``w_q``) and fp8 (``itemsize == 1``) branches are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _no_int8(p) -> None:
    if "w_q" in p:
        raise NotImplementedError("int8 weights are not ported yet")


def _no_fp8(*xs: torch.Tensor) -> None:
    if any(x.element_size() == 1 for x in xs):
        raise NotImplementedError("fp8 KV caches are not ported yet")


def linear(p, x: torch.Tensor) -> torch.Tensor:
    _no_int8(p)
    y = torch.matmul(x, p["w"]).float()
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
    _no_int8(p)
    w = p["w"]
    pad = (w.shape[-1] - 1) // 2
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), stride=stride, padding=pad)
    y = y.transpose(1, 2).float() + p["b"].float()
    return y.to(x.dtype)


def embed(tok_emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(tok_emb, dict):
        raise NotImplementedError("int8 embedding tables are not ported yet")
    return tok_emb[tokens]


def unembed(tok_emb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits projection against the embedding table: [..., d] → [..., V] f32."""
    if isinstance(tok_emb, dict):
        raise NotImplementedError("int8 embedding tables are not ported yet")
    return torch.matmul(x.float(), tok_emb.float().t())


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
    [B, Tq, H, Dh] in ``v.dtype``."""
    _no_fp8(k, v)
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
    layout ``decoder.precompute_cross_kv`` stores). Returns [B, Tq, H, Dh]."""
    _no_fp8(kT, vT)
    dh = q.shape[-1]
    qt = q.transpose(1, 2)  # [B, H, Tq, Dh]
    scores = torch.matmul(qt.float(), kT.float()) * (1.0 / float(dh) ** 0.5)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(vT.dtype), vT.transpose(-1, -2))  # [B, H, Tq, Dh]
    return out.transpose(1, 2).to(vT.dtype)


def mha_self(p, x: torch.Tensor, n_head: int, mask=None, fused: bool = False):
    """Full (non-cached) multi-head self-attention block body.

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
    return linear(p["o"], merge_heads(o))


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))
