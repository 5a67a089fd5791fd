"""Timing probe of the fused beam step's KV streams at full width (K3's path).

    python3 -m whisper_tpu_torch.utils.probe_fused [model] [batch] [beam] [ctx]
        [--kv float8_e4m3fn] [--iters 16] [--mode attend|dma|hybrid]

Counterpart of ``tools/probe_fused.py`` (defaults ``large-v3 16 5 256``).
On random ping-pong planes ``[2, L, B·beam, ctx, D]`` in the ``--kv``
dtype and a bf16 query ``h`` [B·beam, D], each iteration is one beam step
over all L decoder layers with the rotation ``idx = (arange(BK) + 1) % BK``
at ``pos = ctx − 1`` and read plane ``i % 2``; each layer's output goes
through ``tanh`` into the next layer as its query and new K/V rows. Modes:

* ``attend``: K3, ``ops/gather_attend.fused_gather_attend``;
* ``dma``: K2 alone, ``ops/fused_step.permute_append`` (the output is ``h``);
* ``hybrid``: K2 plus ``layers.qkv_attention`` over the written window, the
  port's hybrid beam step.

It prints the time per L-layer step from CUDA events around the timed
iterations (host enqueue included: the loop is eager), the bytes the
planes' windows move, and the card's name and power limit; the last line is
one JSON object. :func:`run` is the entry point for scripts and tests; it
defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.ops.fused_step import permute_append
from whisper_tpu_torch.ops.gather_attend import fused_gather_attend

MODES = ("attend", "dma", "hybrid")
_MANTISSA_BITS = {torch.float8_e4m3fn: 3, torch.bfloat16: 7, torch.float32: 23}


def run(
    model: str = "large-v3", batch: int = 16, beam: int = 5, ctx: int = 256,
    kv: str = "float8_e4m3fn", iters: int = 16, mode: str = "attend", *,
    warmup: int = 1, device: str = "cuda",
) -> dict:
    """Run ``warmup + iters`` beam steps of ``mode`` (module docstring).
    Returns the final ``h``, the planes ``(pk, pv)``, ``steps`` (iterations
    run), ``layers``, ``gb`` (bytes read and written per step over the K and
    V windows, GB) and ``ms_per_step`` (CUDA events over the ``iters``
    timed steps; None on the CPU, which has no device time)."""
    if mode not in MODES:
        raise ValueError(f"probe_fused: mode {mode!r} not in {MODES}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_fused: device 'cuda' requested but torch.cuda.is_available() is false")
    dims = MODEL_DIMS[model]
    n_layer, n_head, d = dims.n_text_layer, dims.n_text_head, dims.n_text_state
    bk, dh, pos = batch * beam, d // n_head, ctx - 1
    gen = torch.Generator(device=dev).manual_seed(0)
    kv_dtype = getattr(torch, kv)
    pk, pv = (
        torch.randn((2, n_layer, bk, ctx, d), generator=gen, device=dev, dtype=torch.bfloat16).to(kv_dtype)
        for _ in range(2)
    )
    h = torch.randn((bk, d), generator=gen, device=dev, dtype=torch.bfloat16)
    rot = (torch.arange(bk, dtype=torch.int32, device=dev) + 1) % bk

    def step(i: int, h: torch.Tensor) -> torch.Tensor:
        par = i % 2
        for layer in range(n_layer):
            if mode == "attend":
                attn, _, _ = fused_gather_attend(pk, pv, rot, layer, pos, par, h, h, h, n_head=n_head)
            else:
                permute_append(pk, pv, rot, layer, pos, par, h, h)
                if mode == "dma":
                    attn = h
                else:
                    k, v = (p[1 - par, layer, :, : pos + 1].view(bk, pos + 1, n_head, dh) for p in (pk, pv))
                    attn = layers.qkv_attention(h.view(bk, 1, n_head, dh), k, v, None).reshape(bk, d)
            h = torch.tanh(attn).to(h.dtype)
        return h

    for i in range(warmup):
        h = step(i, h)
    ms = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for i in range(warmup, warmup + iters):
        h = step(i, h)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / max(iters, 1)
    gb = 2 * 2 * n_layer * bk * ctx * d * pk.element_size() / 1e9  # read + write of K and V
    return {
        "h": h, "planes": (pk, pv), "steps": warmup + iters, "layers": n_layer,
        "gb": gb, "ms_per_step": ms,
    }


def _ulp(dtype: torch.dtype, magnitude: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(magnitude, 2.0**-20))) - _MANTISSA_BITS[dtype])


def compare_runs(a: dict, b: dict, *, h_storage_ulps: int = 0) -> dict:
    """Compare two runs of ONE iteration (read plane 0, write plane 1), e.g.
    ``attend`` and ``hybrid`` (both start from the same random planes and
    ``h``). Both gather the same
    bytes, so the write plane's window ``[0, pos)`` of every layer, the
    read plane, and layer 0's new row (the shared first ``h``) must be
    bitwise equal. The two modes round their softmax at different places,
    so ``h`` may differ: it is held to 4 ulps of bf16 at max|h|. The new
    rows of later layers are each mode's own layer input in the storage
    dtype, so they are held to one storage ulp at their largest magnitude
    plus that. Where the storage is coarser than bf16 (fp8), a new row that
    rounds to the neighbouring storage value moves the next layers' output
    by up to a storage ulp: ``h_storage_ulps`` adds that many storage ulps
    at max|h| to ``h``'s limit, for inputs where such a rounding happens
    (few heads and positions, so one row weighs much)."""
    (ak, av), (bk_, bv) = a["planes"], b["planes"]
    pos = ak.shape[3] - 1
    raw = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    gathered = all(
        torch.equal(raw(x[1, :, :, :pos]), raw(y[1, :, :, :pos])) and torch.equal(raw(x[0]), raw(y[0]))
        and torch.equal(raw(x[1, 0, :, pos]), raw(y[1, 0, :, pos]))
        for x, y in ((ak, bk_), (av, bv))
    )
    h_err = (a["h"].float() - b["h"].float()).abs().max().item()
    h_max = b["h"].float().abs().max().item()
    h_tol = 4 * _ulp(torch.bfloat16, h_max) + h_storage_ulps * _ulp(ak.dtype, h_max)
    rows_err, rows_tol = 0.0, 0.0
    if ak.shape[1] > 1:
        rows = [(x[1, 1:, :, pos].float(), y[1, 1:, :, pos].float()) for x, y in ((ak, bk_), (av, bv))]
        rows_err = max((x - y).abs().max().item() for x, y in rows)
        rows_max = max(y.abs().max().item() for _, y in rows)
        rows_tol = _ulp(ak.dtype, rows_max) + h_tol
    return {
        "gathered_equal": gathered, "h_err": h_err, "h_max": h_max, "h_tol": h_tol,
        "new_rows_err": rows_err, "new_rows_tol": rows_tol,
        "ok": gathered and h_err <= h_tol and rows_err <= rows_tol,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="large-v3")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("beam", nargs="?", type=int, default=5)
    ap.add_argument("ctx", nargs="?", type=int, default=256)
    ap.add_argument("--kv", default="float8_e4m3fn")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--mode", default="attend", choices=MODES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_fused: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        f"model={args.model} bk={args.batch * args.beam} ctx={args.ctx} kv={args.kv} "
        f"iters={args.iters} mode={args.mode}", flush=True,
    )
    res = run(args.model, args.batch, args.beam, args.ctx, args.kv, args.iters, args.mode)
    ms, gb = res["ms_per_step"], res["gb"]
    print(f"{args.mode} x{res['layers']}: {ms:8.3f} ms/step ({gb / ms * 1e3:6.0f} GB/s of {gb:.2f} GB r+w)")
    print(card)
    print(json.dumps({
        "card": card, "model": args.model, "batch": args.batch, "beam": args.beam, "ctx": args.ctx,
        "kv": args.kv, "iters": args.iters, "mode": args.mode, "ms_per_step": ms, "gb": gb,
    }))


if __name__ == "__main__":
    main()
