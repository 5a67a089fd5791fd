"""Timing probe of the decode step's cross-attention read at full width (K6's path).

    python3 -m whisper_tpu_torch.utils.probe_cross [model] [batch] [beam]
        [--kv float8_e4m3fn] [--iters 16] [--tk 1500]
        [--mode prod|bf16|stage|dmastage|chunk|kernel]

Counterpart of ``tools/probe_cross.py`` (defaults ``large-v3 16 5``, 16
iterations, Tk 1500; its ``PROBE_*`` environment variables are flags here).
On random cross K and V ``[L, B, H, Dh, Tk]`` in the store dtype and a bf16
query ``q0`` [B, beam, H, Dh] (the beam folded into the query rows), each
iteration runs all L decoder layers, and each layer computes
``q = tanh(cross(q, K_l, V_l))`` in q's dtype, so the serial dependence
through q keeps anything from being hoisted. The cross read by mode:

* ``prod``: ``ops/cross_attend.cross_attend_reference`` on the fp8 store,
  the PyTorch ops ``models/layers.cross_attention_T`` ran on the card until
  the kernel below (its plain version since);
* ``bf16``: the same function on a bf16 store;
* ``stage``: ``.to(torch.bfloat16)`` of the layer's K and V, then
  the plain version (eager torch materialises each op);
* ``dmastage``: K6, ``ops/fp8_upcast.dma_upcast``, on the layer's K and V
  as ``[B·H·Dh, Tk]`` planes, then the plain version; a 2-byte store is
  refused (the TPU kernel copies it, which is not ported);
* ``chunk``: :func:`cross_chunked`, Tk in halves with an online max/sum
  merge, in JAX's arithmetic;
* ``kernel``: ``ops/cross_attend.cross_attend``, the hand-written kernel
  ``cross_attention_T`` now calls on the card, on the ``--kv`` store (one
  launch a layer that reads the stored K and V once).

It prints the time per L-layer iteration from CUDA events around the timed
iterations (host enqueue included: the loop is eager, so where an
iteration's device work is short, as the ``kernel`` mode's 32 launches
are, the host's enqueue paces it and the time varies with the host's
load), the device time of one iteration's kernels (profiler; the host's
pace left out), JAX's window read
(``gb``: the K and V store bytes) and the rate over it, the bytes the
formulation moves as reckoned from its ops (:func:`moved_bytes`) beside the
fp8 window's bound, the device launches of one iteration and its
costliest kernels (profiler), K6's and the cross-attention kernel's
launches, and the card's name and power limit; the last line is one
JSON object. :func:`run` is the entry point for scripts and tests; it
defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.ops import cross_attend, fp8_upcast

MODES = ("prod", "bf16", "stage", "dmastage", "chunk", "kernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)


def cross_chunked(
    q: torch.Tensor, kT: torch.Tensor, vT: torch.Tensor, n_chunks: int = 2
) -> torch.Tensor:
    """Cross-attention with Tk split into ``n_chunks`` and an online max/sum
    merge, the counterpart of JAX's ``cross_chunked``: per chunk, f32 scores
    from operands in q's dtype (fp8 upcast first), weights in the value's
    dtype, the value product summed in f32; then the chunks merged in f32
    and the result cast to q's dtype. As JAX's, it reads ``Tk // n_chunks``
    columns per chunk. q [B, Tq, H, Dh]; kT, vT [B, H, Dh, Tk] → [B, Tq, H, Dh]."""
    dh = q.shape[-1]
    qt = q.transpose(1, 2).float()  # [B, H, Tq, Dh]
    cs = kT.shape[-1] // n_chunks
    outs, ms, ls = [], [], []
    for c in range(n_chunks):
        kc, vc = kT[..., c * cs : (c + 1) * cs], vT[..., c * cs : (c + 1) * cs]
        if kc.element_size() == 1:
            kc = kc.to(q.dtype)
        if vc.element_size() == 1:
            vc = vc.to(q.dtype)
        s = torch.matmul(qt, kc.float()) * (1.0 / float(dh) ** 0.5)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        outs.append(torch.matmul(p.to(vc.dtype).float(), vc.float().transpose(-1, -2)))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
    m_all = functools.reduce(torch.maximum, ms)
    num = sum(o * torch.exp(m - m_all) for o, m in zip(outs, ms))
    den = sum(l * torch.exp(m - m_all) for l, m in zip(ls, ms))
    return (num / den).transpose(1, 2).to(q.dtype)


def _cross(mode: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One layer's cross read of ``mode`` (module docstring)."""
    if mode == "stage":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif mode == "dmastage":
        k, v = (fp8_upcast.dma_upcast(x.reshape(-1, x.shape[-1])).reshape(x.shape) for x in (k, v))
    if mode == "chunk":
        return cross_chunked(q, k, v)
    if mode == "kernel":
        return cross_attend.cross_attend(q, k, v)
    return cross_attend.cross_attend_reference(q, k, v)


def moved_bytes(
    mode: str, n_layer: int, b: int, tq: int, h: int, dh: int, tk: int, store_itemsize: int
) -> int:
    """Bytes one L-layer iteration of ``mode`` moves through device memory,
    reckoned from its ops with a bf16 query: each op reads its inputs once
    and writes its output once. Per layer, over the n = B·H·Dh·Tk elements
    of K (and of V) and the s = B·H·Tq·Tk scores (q- and output-sized terms,
    Tq/Tk of these, are left out):

    * the plain version (``prod``, ``bf16``): an fp8 K or V upcast to bf16
      (1 + 2 per element);
      ``kT.float()`` (2 + 4, or nothing on an f32 store) and the score product's
      read of it (4); the value product's read of V (its dtype); the scores
      written (4), scaled (4 + 4), softmaxed (4 + 4), cast to V's dtype and
      read by the value product;
    * ``stage`` and ``dmastage`` make that upcast themselves and run the above
      on bf16: the same bytes;
    * ``chunk`` (:func:`cross_chunked`): K and V each upcast, made f32 and read
      (13 per element from fp8); the scores written (4), scaled (4 + 4), their
      max read (4), ``s - m`` (4 + 4), ``exp`` (4 + 4), the sum read (4), the
      weights cast to V's dtype and back to f32 and read (4 + 2 + 2 + 4 + 4);
    * ``kernel``: K and V read once in the store's dtype; the scores stay in
      shared memory."""
    n, s = b * h * dh * tk, b * h * tq * tk
    i = 2 if mode == "bf16" else store_itemsize
    up = i + 2 if i == 1 else 0  # an fp8 plane upcast to bf16
    c = 2 if i == 1 else i  # the dtype the products read K and V in
    as_f32 = c + 4 if c != 4 else 0
    if mode == "kernel":
        return n_layer * n * 2 * i
    if mode == "chunk":
        per_n = 2 * (up + as_f32 + 4)
        per_s = 4 + 8 + 4 + 8 + 8 + 4 + (4 + c if c != 4 else 0) + as_f32 + 4
    else:
        per_n = 2 * up + as_f32 + 4 + c  # stage and dmastage: the same upcast, made apart
        per_s = 4 + 8 + 8 + (4 + c if c != 4 else 0) + c
    return n_layer * (n * per_n + s * per_s)


def make_inputs(model: str, batch: int, beam: int, tk: int, store: torch.dtype, device) -> tuple:
    """``(q0, xk, xv)`` from seed 0: each drawn as bf16 normals from a fresh
    ``torch.Generator`` seeded 0 (JAX draws all three from one key, so its K
    and V are equal; here too), K and V then cast to ``store``."""
    dims = MODEL_DIMS[model]
    n_layer, n_head = dims.n_text_layer, dims.n_text_head
    dh = dims.n_text_state // n_head
    gen = torch.Generator(device=device)

    def draw(shape):
        gen.manual_seed(0)
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)

    kv_shape = (n_layer, batch, n_head, dh, tk)
    return draw((batch, beam, n_head, dh)), draw(kv_shape).to(store), draw(kv_shape).to(store)


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A test's input (numpy in a dtype torch reads, e.g. float32 holding
    JAX's bf16 or fp8 values exactly, or a tensor) in ``dtype`` on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype).contiguous()


TRACE_PAD_S = 0.05  # host seconds at each end of a traced step, inside the profiler's window


def traced_step(step, q, top: int = 6):
    """(q after one ``step``, its device launches, its ``top`` device
    kernels by time as {name: ms}, the device ms of all its kernels) from a
    ``torch.profiler`` trace; the launches and the ms are None where the
    trace holds no device event. CUDA activity only, and the step runs
    :data:`TRACE_PAD_S` after the profiler starts and ends as long before
    it stops: a trace with CPU activity too, padded or not, has read some
    17–20 kernels fewer than an iteration launched on an H100 (44–47 of
    the ``kernel`` mode's 64)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        q = step(q)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    kernels = {name: {"count": n, "ms": us / 1e3} for name, (n, us) in ranked}
    device_ms = sum(us for _, us in by_name.values()) / 1e3 if by_name else None
    return q, sum(n for n, _ in by_name.values()) or None, kernels, device_ms


def run(
    model: str = "large-v3", batch: int = 16, beam: int = 5, tk: int = 1500,
    kv: str = "float8_e4m3fn", iters: int = 16, mode: str = "prod", *,
    warmup: int = 1, device: str = "cuda", inputs=None,
) -> dict:
    """Run ``warmup + iters`` iterations of ``mode`` (module docstring) from
    ``inputs=(q0, xk, xv)`` or, where None, :func:`make_inputs`. Returns the
    final ``q``, ``steps`` (iterations run), ``layers``, ``gb`` (JAX's
    window read per iteration: the K and V store bytes, GB), ``moved_gb``
    (:func:`moved_bytes`, GB), ``bound_ms`` (the fp8 window read once at
    the H100's memory rate), ``ms_per_iter`` (CUDA events over the ``iters``
    timed iterations), ``device_ms_per_iter``, ``launches_per_iter`` and
    ``top_kernels`` (the device ms of all kernels of the last warm-up
    iteration, their count and the costliest of them by device ms, from
    the profiler), ``k6_launches`` (K6's launches in this
    run) and ``cross_launches`` (the cross-attention kernel's); the times
    and launches are None on the CPU."""
    if mode not in MODES:
        raise ValueError(f"probe_cross: mode {mode!r} not in {MODES}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "probe_cross: device 'cuda' requested but torch.cuda.is_available() is false"
        )
    store = torch.bfloat16 if mode == "bf16" else getattr(torch, kv)
    if mode == "dmastage" and store.itemsize != 1:
        raise ValueError(f"probe_cross: dmastage takes an fp8 store, got {store} "
                         "(the TPU kernel's 2-byte copy is not ported)")
    dims = MODEL_DIMS[model]
    n_layer, n_head = dims.n_text_layer, dims.n_text_head
    dh = dims.n_text_state // n_head
    if inputs is None:
        q, xk, xv = make_inputs(model, batch, beam, tk, store, dev)
    else:
        q = as_tensor(inputs[0], torch.bfloat16, dev)
        xk, xv = (as_tensor(x, store, dev) for x in inputs[1:])
    batch, beam = q.shape[:2]
    tk = xk.shape[-1]
    if xk.shape != (n_layer, batch, n_head, dh, tk) or xv.shape != xk.shape:
        raise ValueError(f"probe_cross: K, V {tuple(xk.shape)}, {tuple(xv.shape)} do not fit "
                         f"q {tuple(q.shape)} at {model}")

    def step(q: torch.Tensor) -> torch.Tensor:
        for layer in range(n_layer):
            q = torch.tanh(_cross(mode, q, xk[layer], xv[layer])).to(q.dtype)
        return q

    k6_before, cross_before = fp8_upcast.launches, cross_attend.launches
    per_iter, top, device_ms = None, None, None
    for i in range(warmup):
        if dev.type == "cuda" and i == warmup - 1:
            q, per_iter, top, device_ms = traced_step(step, q)
        else:
            q = step(q)
    ms = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(iters):
        q = step(q)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / max(iters, 1)
    window = 2 * n_layer * batch * n_head * dh * tk
    return {
        "q": q, "steps": warmup + iters, "layers": n_layer,
        "gb": window * xk.element_size() / 1e9,
        "moved_gb": moved_bytes(mode, n_layer, batch, beam, n_head, dh, tk, xk.element_size())
        / 1e9,
        "bound_ms": window / HBM_BYTES_PER_S * 1e3,
        "ms_per_iter": ms, "device_ms_per_iter": device_ms, "launches_per_iter": per_iter,
        "top_kernels": top, "k6_launches": fp8_upcast.launches - k6_before if dev.type == "cuda" else None,
        "cross_launches": cross_attend.launches - cross_before if dev.type == "cuda" else None,
    }


def record(mode: str, res: dict) -> dict:
    """The printable record of one run (everything but ``q``)."""
    ms = res["ms_per_iter"]
    return {
        "mode": mode, "ms_per_iter": ms, "device_ms_per_iter": res["device_ms_per_iter"], "gb": res["gb"],
        "gb_per_s": res["gb"] / ms * 1e3 if ms else None,
        "moved_gb": res["moved_gb"], "bound_ms": res["bound_ms"],
        "launches_per_iter": res["launches_per_iter"], "top_kernels": res["top_kernels"],
        "k6_launches": res["k6_launches"], "cross_launches": res["cross_launches"],
        "steps": res["steps"],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="large-v3")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("beam", nargs="?", type=int, default=5)
    ap.add_argument("--kv", default="float8_e4m3fn")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--tk", type=int, default=1500)
    ap.add_argument("--mode", default="prod", choices=MODES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_cross: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    store = "bfloat16" if args.mode == "bf16" else args.kv
    print(f"mode={args.mode} model={args.model} b={args.batch} beam={args.beam} tk={args.tk} "
          f"store={store} iters={args.iters}", flush=True)
    res = run(args.model, args.batch, args.beam, args.tk, args.kv, args.iters, args.mode)
    rec = record(args.mode, res)
    print(f"cross x{res['layers']}: {rec['ms_per_iter']:8.3f} ms/iter, {rec['device_ms_per_iter']:.3f} "
          f"device ms/iter ({rec['gb_per_s']:6.0f} GB/s "
          f"of {rec['gb']:.2f} GB window read); moves {rec['moved_gb']:.2f} GB by its ops; fp8 "
          f"window bound {rec['bound_ms']:.3f} ms; {rec['launches_per_iter']} launches/iter, "
          f"K6 {rec['k6_launches']}, cross_attend {rec['cross_launches']}")
    for name, k in (rec["top_kernels"] or {}).items():
        print(f"  {k['ms']:8.3f} ms in {k['count']:4d} launches of {name[:240]}")
    print(card)
    print(json.dumps({"card": card, "model": args.model, "batch": args.batch, "beam": args.beam,
                      "tk": args.tk, "kv": args.kv, "iters": args.iters, **rec}))


if __name__ == "__main__":
    main()
