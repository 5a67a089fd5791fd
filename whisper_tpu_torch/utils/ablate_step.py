"""Micro-ablation of one decode step's components at exact model shapes.

    python3 -m whisper_tpu_torch.utils.ablate_step [model] [batch] [beam]
        [--kv bfloat16|float8_e4m3fn] [--iters 16] [--quant int8]

Counterpart of ``tools/ablate_step.py`` (defaults ``large-v3 16 1``, the
cache in bfloat16, 16 iterations, ``CTX = 228``; its ``ABLATE_KV``,
``ABLATE_ITERS`` and ``ABLATE_QUANT`` environment variables are read here
too, and the flags override them). Each stream of one decode step is timed
alone, so that the gap between a measured step and its bound can be
attributed stream by stream:

* ``cross``: ``layers.cross_attention_T`` over the cross K/V ``[L, B, H,
  Dh, Tk]`` in the cache dtype (the beam folded into the query rows);
* ``self``: the self-attention cache ``[L, BK, CTX, H, Dh]``, each layer
  writing its new row at position 100 and reading its window through
  ``layers.qkv_attention``, the cache carried from iteration to iteration;
* ``weights`` (and ``weights_int8`` under ``--quant int8``): each layer's
  q, k, v, o, cross q, cross o and MLP through ``layers.linear`` and
  ``layers.mlp`` exactly as the decoder calls them, on bf16 weights (or the
  int8 tree of ``models/quantize.quantize_params``: does an int8 weight
  cost less than a bf16 one at decode shapes, or is it cast per use?);
* ``unembed``: ``layers.unembed`` against the bf16 token table;
* ``argmax``, ``log_softmax``, and with a beam ``topk_wide`` (the port's
  beam selection, k = beam + 1) and ``torch.topk`` (JAX's ``lax.top_k``);
* with a beam, the cache reorder by a rotation of the rows: by
  ``index_select`` of the bytes (JAX's ``jnp.take``), by a one-hot bf16
  product (JAX's default ``reorder_cache``; −0 comes back +0), by an int8 one-hot product on
  the fp8 bytes (``torch._int_mm``, where its shape rules fit: m > 16, k and
  n multiples of 8; else the row is not run and says why), and by K4
  (``ops/gather.permute_rows``, where JAX calls its Pallas kernel);
* ``self_T``: the self-attention read from a T-layout cache ``[L, BK, H,
  Dh, CTX]``;
* ``fused``, with a beam: K3 (``ops/gather_attend.fused_gather_attend``)
  on K2's plane layout ``[2, L, BK, CTXP, D]`` (CTXP = CTX rounded up to
  64), each layer gathering through the rotation, appending at CTXP − 1 and
  attending, the planes alternating.

JAX's ``fori_loop`` inside one jit exists so that XLA cannot hoist the
work; the port keeps its meaning, not its mechanism: each component runs
``iters`` times as eager torch, each iteration reading the carry the last
one wrote, from operands drawn by an explicit ``torch.Generator`` (seed 0
before every draw, as JAX draws every operand from one key). Each of one
warm-up and 3 timed repeats starts from a copy of the initial carry (as
JAX's program starts from its inputs); the time is the min over the
repeats of CUDA events around the ``iters`` iterations, per iteration.

Each row prints its ms per iteration, the rate over JAX's bytes per
iteration (``gb``), the bound of those bytes at the H100's 3.35 TB/s, and
the device launches of one iteration (from the profiler); K3 and K4 are
counted too. The card's name and power limit (nvidia-smi) come first and
the last line is one JSON object. :func:`run` is the entry point for
scripts and tests: it defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode.beam import topk_wide
from whisper_tpu_torch.decode.greedy import argmax_last
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.params import init_params, leaves
from whisper_tpu_torch.models.quantize import quantize_params
from whisper_tpu_torch.ops import gather, gather_attend
from whisper_tpu_torch.utils.bench import card_line
from whisper_tpu_torch.utils.probe_cross import HBM_BYTES_PER_S, as_tensor, traced_step

CTX = 228
WRITE_POS = 100  # the self rows' write position (JAX's dynamic_update_slice)
REPEATS = 3


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- one iteration of each row: step(carry, i, *consts) -> carry ------------
def cross_step(q, i, xk, xv):
    """Every layer's cross read, q [BK, 1, H, Dh] → the same; the beam folds
    into the query rows of its batch row."""
    b = xk.shape[1]
    for layer in range(xk.shape[0]):
        if q.shape[0] != b:
            bk, _, h, dh = q.shape
            o = layers.cross_attention_T(q.reshape(b, bk // b, h, dh), xk[layer], xv[layer])
            o = o.reshape(bk, 1, h, dh)
        else:
            o = layers.cross_attention_T(q, xk[layer], xv[layer])
        q = o.to(q.dtype)
    return q


def self_step(carry, i, mask):
    """The carried cache: each layer writes its row at ``WRITE_POS`` (in
    place) and reads its window."""
    q, ck, cv = carry
    for layer in range(ck.shape[0]):
        ck[layer, :, WRITE_POS : WRITE_POS + 1] = q.to(ck.dtype)
        cv[layer, :, WRITE_POS : WRITE_POS + 1] = q.to(cv.dtype)
        q = layers.qkv_attention(q, ck[layer], cv[layer], mask).to(q.dtype)
    return q, ck, cv


def weights_step(x, i, blocks):
    """Each layer's weight GEMMs, x [BK, 1, D]; ``tanh`` keeps the chain in range."""
    for bp in blocks:
        h = x
        for p in (bp["attn"]["q"], bp["attn"]["k"], bp["attn"]["v"], bp["attn"]["o"],
                  bp["cross"]["q"], bp["cross"]["o"]):
            h = layers.linear(p, h)
        x = torch.tanh(layers.mlp(bp["mlp"], h)).to(x.dtype)
    return x


def unembed_step(x, i, emb):
    lg = layers.unembed(emb, x)
    return torch.tanh(lg[:, : x.shape[-1]]).to(x.dtype)


def argmax_step(lg, i):
    idx = argmax_last(lg)
    lg[:, 0] += 1e-9 * idx.sum().float()
    return lg


def log_softmax_step(lg, i):
    lp = torch.log_softmax(lg, dim=-1)
    lg[:, 0] += 1e-9 * lp[0, 0]
    return lg


def topk_wide_step(lg, i, k):
    _, idx = topk_wide(lg, k)
    lg[:, 0] += 1e-9 * idx.sum().float()
    return lg


def topk_step(lg, i, k):
    _, idx = torch.topk(lg, k, dim=-1)
    lg[:, 0] += 1e-9 * idx.sum().float()
    return lg


def reorder_index_select(cache, i, rot):
    """``out[l, n] = x[l, rot[n]]`` by ``index_select`` over the bytes."""
    return {n: v.view(torch.uint8).index_select(1, rot).view(v.dtype) for n, v in cache.items()}


def reorder_onehot(cache, i, rot):
    """JAX's default ``reorder_cache``: a one-hot product in bf16 (the
    cache's dtype if wider than a byte), cast back; exact in value, but a
    stored −0 comes back +0 (x·1 + 0·y), as in JAX."""
    out = {}
    for n, x in cache.items():
        compute = torch.bfloat16 if x.element_size() == 1 else x.dtype
        perm = F.one_hot(rot, x.shape[1]).to(compute)
        out[n] = torch.einsum("nj,ljthd->lnthd", perm, x.to(compute)).to(x.dtype)
    return out


def int_mm_fits(m: int, k: int, n: int) -> bool:
    """``torch._int_mm``'s shape rules on the card: m > 16, k and n
    multiples of 8."""
    return m > 16 and k > 0 and k % 8 == 0 and n % 8 == 0


def reorder_int8(cache, i, rot):
    """The one-hot product on the 1-byte cache's bits as int8, summed in
    int32 (exact: one product per output) and cast back, layer by layer.
    On the card ``torch._int_mm`` (cuBLASLt's int8 product) refuses a
    row-major second operand, so each layer's bytes are first copied to
    column-major; the copy is part of the row's cost."""
    out = {}
    for n, x in cache.items():
        bk = x.shape[1]
        perm = F.one_hot(rot, bk).to(torch.int8)
        xi = x.view(torch.int8)
        y = torch.stack([torch._int_mm(perm, xi[layer].reshape(bk, -1).t().contiguous().t())
                         for layer in range(x.shape[0])])
        out[n] = y.to(torch.int8).view(x.dtype).reshape(x.shape)
    return out


def reorder_k4(cache, i, rot32):
    return {n: gather.permute_rows(v, rot32) for n, v in cache.items()}


def self_T_step(carry, i, mask_t):
    """The T-layout cache: each layer writes its column at ``WRITE_POS`` and
    reads K as [H, Dh, CTX] (f32 scores, weights in V's dtype, f32 sums)."""
    q, ck, cv = carry
    bk, _, h, dh = q.shape
    for layer in range(ck.shape[0]):
        new = q[:, 0].reshape(bk, h, dh, 1)
        ck[layer, ..., WRITE_POS : WRITE_POS + 1] = new.to(ck.dtype)
        cv[layer, ..., WRITE_POS : WRITE_POS + 1] = new.to(cv.dtype)
        kt, vt = ck[layer], cv[layer]
        if kt.element_size() == 1:
            kt = kt.to(q.dtype)
        if vt.element_size() == 1:
            vt = vt.to(q.dtype)
        qt = q.transpose(1, 2)  # [BK, H, 1, Dh]
        scores = torch.matmul(qt.float(), kt.float()) * (1.0 / float(dh) ** 0.5)
        w = torch.softmax(scores + mask_t, dim=-1)
        o = torch.matmul(w.to(vt.dtype).float(), vt.float().transpose(-1, -2))
        q = o.transpose(1, 2).to(q.dtype)
    return q, ck, cv


def fused_step(carry, i, rot32, n_head):
    """K3 per layer on the planes, appending at the last position of the
    window; the read plane is ``i % 2``."""
    h, pk, pv = carry
    pos = pk.shape[3] - 1
    for layer in range(pk.shape[1]):
        attn, pk, pv = gather_attend.fused_gather_attend(pk, pv, rot32, layer, pos, i % 2, h, h, h,
                                                         n_head=n_head)
        h = torch.tanh(attn).to(h.dtype)
    return h, pk, pv


# --- operands ------------------------------------------------------------------
def make_inputs(model: str, batch: int, beam: int, kv: str, quant: Optional[str], device) -> dict:
    """Every row's operands, each drawn from a ``torch.Generator`` seeded 0
    before the draw (as JAX draws each from one key), at JAX's shapes and
    dtypes: q0, xk, xv, ck, cv, ckT, cvT, pk, pv and fq0 in bf16 (the
    caches then in ``kv``), the decoder's bf16 weights (and their int8
    tree), x0, u0 and the f32 logits lg0."""
    dims = MODEL_DIMS[model]
    n_layer, h, d = dims.n_text_layer, dims.n_text_head, dims.n_text_state
    dh, bk, tk = d // h, batch * beam, dims.n_audio_ctx
    ctxp = -(-CTX // 64) * 64
    store = getattr(torch, kv)
    gen = torch.Generator(device=device)

    def draw(shape, dtype=torch.bfloat16):
        gen.manual_seed(0)
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)

    gen.manual_seed(0)
    dec = init_params(dims, gen, dtype=torch.bfloat16, device=device)["decoder"]
    params = {"blocks": dec["blocks"], "tok_emb": dec["tok_emb"]}
    out = {
        "q0": draw((bk, 1, h, dh)),
        "xk": draw((n_layer, batch, h, dh, tk)).to(store),
        "xv": draw((n_layer, batch, h, dh, tk)).to(store),
        "ck": draw((n_layer, bk, CTX, h, dh)).to(store),
        "cv": draw((n_layer, bk, CTX, h, dh)).to(store),
        "params": params,
        "x0": draw((bk, 1, d)),
        "u0": draw((bk, d)),
        "lg0": draw((bk, dims.n_vocab), torch.float32),
        "ckT": draw((n_layer, bk, h, dh, CTX)).to(store),
        "cvT": draw((n_layer, bk, h, dh, CTX)).to(store),
        "pk": draw((2, n_layer, bk, ctxp, d)).to(store),
        "pv": draw((2, n_layer, bk, ctxp, d)).to(store),
        "fq0": draw((bk, d)),
    }
    if quant == "int8":
        out["qparams"] = {"blocks": quantize_params({"decoder": params})["decoder"]["blocks"]}
    return out


def _clone(carry):
    if isinstance(carry, torch.Tensor):
        return carry.clone()
    if isinstance(carry, dict):
        return {k: v.clone() for k, v in carry.items()}
    return tuple(_clone(c) for c in carry)


def _leaves(carry) -> list:
    if isinstance(carry, torch.Tensor):
        return [carry]
    if isinstance(carry, dict):
        return [carry[k] for k in sorted(carry)]
    return [t for c in carry for t in _leaves(c)]


def checksum(carry) -> float:
    """JAX's scalar of a run: the sum over the carry's leaves of each
    leaf's first element in f32 (dict leaves in key order)."""
    return float(sum(t.reshape(-1)[0].float().item() for t in _leaves(carry)))


def timed(name: str, label: str, init, step, consts=(), gb: Optional[float] = None, *,
          iters: int, repeats: int = REPEATS, device: torch.device) -> dict:
    """One row (module docstring): ``1 + repeats`` runs of ``iters``
    iterations, each from a copy of ``init``. Returns its record; ``ms``,
    ``gb_per_s`` and ``launches_per_iter`` are None on the CPU, where K3's
    and K4's launches are 0 (their plain versions run)."""
    cuda = device.type == "cuda"
    k3, k4 = gather_attend.launches, gather.launches
    times, runs = [], 0
    for rep in range(1 + repeats):
        carry = _clone(init)
        if cuda:
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        for i in range(iters):
            carry = step(carry, i, *consts)
        runs += iters
        if cuda:
            end.record()
            end.synchronize()
            if rep:
                times.append(start.elapsed_time(end) / max(iters, 1))
    per_iter = None
    if cuda:
        _, per_iter, _, _ = traced_step(lambda c: step(c, 0, *consts), _clone(init))
        runs += 1
    ms = min(times) if times else None
    return {
        "row": name, "label": label, "ms_per_iter": ms, "gb": gb,
        "gb_per_s": gb / ms * 1e3 if gb and ms else None,
        "bound_ms": gb * 1e9 / HBM_BYTES_PER_S * 1e3 if gb else None,
        "launches_per_iter": per_iter, "iterations": runs,
        "k3_launches": gather_attend.launches - k3, "k4_launches": gather.launches - k4,
        "checksum": checksum(carry), "not_run": None,
    }


def _not_run(name: str, label: str, why: str) -> dict:
    return {"row": name, "label": label, "ms_per_iter": None, "gb": None, "gb_per_s": None,
            "bound_ms": None, "launches_per_iter": None, "iterations": 0, "k3_launches": None,
            "k4_launches": None, "checksum": None, "not_run": why}


def run(
    model: str = "large-v3", batch: int = 16, beam: int = 1, kv: str = "bfloat16",
    iters: int = 16, quant: Optional[str] = None, *, repeats: int = REPEATS,
    device: str = "cuda", inputs: Optional[dict] = None, log=None,
) -> list:
    """Every row of the module docstring, in the tool's order. ``inputs``:
    :func:`make_inputs`' operands (tests hand in the JAX tool's, as numpy;
    ``params`` and ``qparams`` as port trees); None draws them on
    ``device``. ``log``: called with each row's printed line. Returns the
    rows' records."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ablate_step: device 'cuda' requested but torch.cuda.is_available() is false")
    if quant not in (None, "int8"):
        raise ValueError(f"ablate_step: quant {quant!r} is not None or 'int8'")
    dims = MODEL_DIMS[model]
    n_layer, h, d = dims.n_text_layer, dims.n_text_head, dims.n_text_state
    bk = batch * beam
    store = getattr(torch, kv)
    if inputs is None:
        ops = make_inputs(model, batch, beam, kv, quant, dev)
    else:
        ops = {k: v for k, v in inputs.items() if k in ("params", "qparams")}
        for k in ("q0", "x0", "u0", "fq0"):
            ops[k] = as_tensor(inputs[k], torch.bfloat16, dev)
        ops["lg0"] = as_tensor(inputs["lg0"], torch.float32, dev)
        for k in ("xk", "xv", "ck", "cv", "ckT", "cvT", "pk", "pv"):
            ops[k] = as_tensor(inputs[k], store, dev)
    records = []

    def row(name, label, init, step, consts=(), gb=None):
        rec = timed(name, label, init, step, consts, gb, iters=iters, repeats=repeats, device=dev)
        records.append(rec)
        if log:
            log(line(rec))

    def skip(name, label, why):
        records.append(_not_run(name, label, why))
        if log:
            log(line(records[-1]))

    xk, xv, ck, cv = ops["xk"], ops["xv"], ops["ck"], ops["cv"]
    cross_gb = _nbytes((xk, xv)) / 1e9
    row("cross", f"cross-attn x{n_layer} (read {cross_gb:.2f} GB)", ops["q0"], cross_step,
        (xk, xv), cross_gb)
    cache_gb = _nbytes((ck, cv)) / 1e9
    mask = torch.zeros((1, CTX), dtype=torch.bfloat16, device=dev)
    row("self", f"self-attn+update x{n_layer} carried (read {cache_gb:.2f} GB)",
        (ops["q0"], ck, cv), self_step, (mask,), cache_gb)
    blocks = ops["params"]["blocks"]
    dec_gb = _nbytes(leaves(blocks)) / 1e9
    row("weights", f"weight matmuls x{n_layer} ({dec_gb:.2f} GB)", ops["x0"], weights_step,
        (blocks,), dec_gb)
    if quant == "int8":
        qblocks = ops["qparams"]["blocks"]
        qdec_gb = _nbytes(leaves(qblocks)) / 1e9
        row("weights_int8", f"weight matmuls x{n_layer} int8 ({qdec_gb:.2f} GB)", ops["x0"],
            weights_step, (qblocks,), qdec_gb)
    emb = ops["params"]["tok_emb"]
    emb_gb = _nbytes((emb,)) / 1e9
    row("unembed", f"unembed ({emb_gb:.2f} GB)", ops["u0"], unembed_step, (emb,), emb_gb)
    lg0 = ops["lg0"]
    row("argmax", "argmax_last", lg0, argmax_step)
    row("log_softmax", "log_softmax", lg0, log_softmax_step)
    if beam > 1:
        row("topk_wide", f"topk_wide(k={beam + 1})", lg0, topk_wide_step, (beam + 1,))
        row("topk", f"torch.topk(k={beam + 1})", lg0, topk_step, (beam + 1,))
        cache0 = {"k": ck, "v": cv}
        rot32 = ((torch.arange(bk, device=dev) + 1) % bk).to(torch.int32)
        rot = rot32.long()
        row("reorder_index_select", f"cache reorder: index_select (r+w {2 * cache_gb:.2f} GB)",
            cache0, reorder_index_select, (rot,), 2 * cache_gb)
        row("reorder_onehot", "cache reorder: one-hot bf16 matmul", cache0, reorder_onehot, (rot,),
            2 * cache_gb)
        label = "cache reorder: int8-bitcast matmul (torch._int_mm)"
        n = CTX * d
        if store.itemsize != 1:
            skip("reorder_int8", label, f"the cache is {kv}, not 1-byte")
        elif not int_mm_fits(bk, bk, n):
            skip("reorder_int8", label, f"torch._int_mm's shape rules (m > 16, k and n multiples "
                 f"of 8) do not fit m = k = {bk}, n = {n}")
        else:
            row("reorder_int8", label, cache0, reorder_int8, (rot,), 2 * cache_gb)
        if gather.supported(ck):
            row("reorder_k4", "cache reorder: K4 permute_rows", cache0, reorder_k4, (rot32,),
                2 * cache_gb)
    mask_t = torch.zeros((1, 1, 1, CTX), dtype=torch.float32, device=dev)
    row("self_T", f"self-attn+update x{n_layer} T-layout (read {cache_gb:.2f} GB)",
        (ops["q0"], ops["ckT"], ops["cvT"]), self_T_step, (mask_t,), cache_gb)
    if beam > 1 and gather_attend.supported(d, store.itemsize, h):
        pk, pv = ops["pk"], ops["pv"]
        fused_gb = 2 * _nbytes((pk[0], pv[0])) / 1e9  # read + write, K and V
        row("fused", f"fused permute+append+attend x{n_layer} K3 (r+w {fused_gb:.2f} GB)",
            (ops["fq0"], pk, pv), fused_step, (rot32, h), fused_gb)
    return records


def line(rec: dict) -> str:
    """A row's printed line."""
    if rec["not_run"]:
        return f"{rec['label']:56s} not run: {rec['not_run']}"
    if rec["ms_per_iter"] is None:
        return f"{rec['label']:56s} (no card: checksum {rec['checksum']:.6g})"
    out = f"{rec['label']:56s} {rec['ms_per_iter']:9.3f} ms/iter"
    if rec["gb"]:
        out += f" ({rec['gb_per_s']:6.0f} GB/s; bound {rec['bound_ms']:.3f} ms)"
    out += f"  {rec['launches_per_iter']} launches/iter"
    if rec["k3_launches"] or rec["k4_launches"]:
        out += f", K3 {rec['k3_launches']}, K4 {rec['k4_launches']} in {rec['iterations']} iterations"
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="large-v3")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("beam", nargs="?", type=int, default=1)
    ap.add_argument("--kv", default=os.environ.get("ABLATE_KV", "bfloat16"))
    ap.add_argument("--iters", type=int, default=int(os.environ.get("ABLATE_ITERS", "16")))
    ap.add_argument("--quant", default=os.environ.get("ABLATE_QUANT") or None, choices=(None, "int8"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ablate_step: needs a CUDA card (torch.cuda.is_available() is false)")
    card = card_line()
    print(card)
    print(f"model={args.model} batch={args.batch} beam={args.beam} kv={args.kv} iters={args.iters} "
          f"quant={args.quant}", flush=True)
    records = run(args.model, args.batch, args.beam, args.kv, args.iters, args.quant,
                  log=lambda s: print(s, flush=True))
    print(json.dumps({"card": card, "model": args.model, "batch": args.batch, "beam": args.beam,
                      "kv": args.kv, "iters": args.iters, "quant": args.quant, "rows": records}))


if __name__ == "__main__":
    main()
