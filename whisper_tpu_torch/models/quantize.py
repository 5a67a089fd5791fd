"""Int8 weight-only quantization (symmetric, per output channel).

Counterpart of ``whisper_tpu/models/quantize.py`` (the port keeps its own
copy). Every matmul or conv weight ``w`` becomes ``{"w_q": int8, "w_s":
f32}`` with a symmetric absmax scale per output channel; the token
embedding becomes ``{"q": int8 [V, d], "s": f32 [V]}`` with per-row scales;
biases, layer-norm affines and the positional embedding stay float. The
layer functions (``models/layers.py``) dispatch on that structure.

Layouts are the port's: transformer blocks are a per-layer list (so a
block weight [d_in, d_out] gets a scale [d_out], the per-layer slice of
JAX's stacked [L, d_out]), and conv weights are ``[c_out, c_in, width]``
with a scale per ``c_out``. The arithmetic is JAX's: an f32 divide, round
half to even, clip to ±127, so ``w_q`` and ``w_s`` equal JAX's bitwise for
the same weights. The work runs on the weights' own device; every divisor
is a tensor there, since PyTorch's CUDA divide by a host scalar multiplies
by its reciprocal, which is an ulp off the divide for some values.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from whisper_tpu_torch.models.params import Params

INT8_MAX = 127.0
_EPS = 1e-12


def _reduce_dims(w: torch.Tensor) -> Tuple[int, ...]:
    """Dims the scale reduces over: all but the output channel."""
    if w.dim() == 2:  # [d_in, d_out]
        return (0,)
    return (1, 2)  # conv [c_out, c_in, width]


def absmax_quantize(w: torch.Tensor, reduce_dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel absmax quantization. Returns (q int8, scale f32)
    with ``scale`` squeezed over ``reduce_dims``; ``q * scale`` reconstructs
    ``w`` to within scale/2 elementwise."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, INT8_MAX), _EPS)
    q = torch.clamp(torch.round(wf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale.squeeze(reduce_dims)


def _is_weight_leaf(node) -> bool:
    return (
        isinstance(node, dict)
        and isinstance(node.get("w"), torch.Tensor)
        and node["w"].dim() in (2, 3)
    )


def _walk(node, fn):
    """Rebuild the tree: each dict becomes ``fn(dict)``, or, where that is
    None, a dict of its walked children."""
    if isinstance(node, dict):
        res = fn(node)
        return res if res is not None else {k: _walk(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, fn) for v in node]
    return node


def quantize_params(params: Params) -> Params:
    """Full-model weight-only int8 quantization (a new tree; the input is
    left as it is)."""

    def quant(node):
        if not _is_weight_leaf(node):
            return None
        q, s = absmax_quantize(node["w"], _reduce_dims(node["w"]))
        out: Dict[str, Any] = {"w_q": q, "w_s": s}
        if "b" in node:
            out["b"] = node["b"]
        return out

    out = _walk(params, quant)
    q, s = absmax_quantize(params["decoder"]["tok_emb"], (1,))
    out["decoder"]["tok_emb"] = {"q": q, "s": s}
    return out


def dequantize_params(params: Params, dtype: torch.dtype = torch.float32) -> Params:
    """Inverse transform (testing and debugging): a float tree."""

    def expand(q, s):
        for d in _reduce_dims(q):
            s = s.unsqueeze(d)
        return (q.float() * s.float()).to(dtype)

    def dequant(node):
        if "w_q" in node:
            out = {"w": expand(node["w_q"], node["w_s"])}
            if "b" in node:
                out["b"] = node["b"]
            return out
        if set(node) == {"q", "s"}:
            return (node["q"].float() * node["s"].float()[:, None]).to(dtype)
        return None

    return _walk(params, dequant)


def is_quantized(params: Params) -> bool:
    return isinstance(params.get("decoder", {}).get("tok_emb"), dict)


def param_bytes(params: Params) -> int:
    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        elif isinstance(node, list):
            for v in node:
                yield from leaves(v)
        else:
            yield node

    return sum(x.numel() * x.element_size() for x in leaves(params))


def quantize_pspecs(pspecs, params_q: Params):
    """The sharding specs of a quantised tree, from the float tree's
    (``parallel/sharding.param_pspecs``; a leaf is the axis the model axis
    cuts, or None): ``w_q`` inherits ``w``'s axis; the per-output scale
    ``w_s`` is cut only where ``w``'s output axis is (a column-parallel
    [d_in, d_out] weight), and is whole for a row-parallel weight or a
    conv; the embedding's per-row scale [V] is replicated, since the
    feature axis that tensor parallelism cuts is reduced away in it. The
    counterpart of JAX's ``quantize_pspecs``."""

    def walk(spec_node, q_node):
        if isinstance(q_node, dict) and "w_q" in q_node:
            w_axis = spec_node["w"]
            out_axis = 0 if q_node["w_q"].dim() == 3 else 1  # conv c_out, linear d_out
            out = {"w_q": w_axis, "w_s": 0 if w_axis == out_axis else None}
            if "b" in q_node:
                out["b"] = spec_node["b"]
            return out
        if isinstance(q_node, dict) and set(q_node) == {"q", "s"}:
            return {"q": spec_node, "s": None}
        if isinstance(q_node, dict):
            return {k: walk(spec_node[k], v) for k, v in q_node.items()}
        if isinstance(q_node, list):
            return [walk(s, v) for s, v in zip(spec_node, q_node)]
        return spec_node

    return walk(pspecs, params_q)
