"""Where the time goes on the port's main path, on one CUDA card.

    python3 -m whisper_tpu_torch.utils.profile_path [--model large-v3] [--batch 4] [--steps 32]
        [--beam 5] [--quantization int8] [--kv-cache-dtype float8_e4m3fn]

Builds a random-weight ``whisper_tpu_torch`` MONOLITH engine on the card,
warms it with one ``transcribe_batch``, then traces the encoder stage and
the decode stage separately with ``torch.profiler`` (CPU + CUDA
activities). For each stage it prints the host wall time, the summed
device-kernel time, the device busy share (kernel time / wall; kernels run
on one stream, so their sum is the busy time), the kernel launch count, and
the kernels that take the most device time, and the share of device time
and the launches of each of the port's own kernels (K1 ``flash_attn_fwd``,
K2 ``permute_append``, K4 ``permute_rows``, the decoder's cross-attention
``cross_attend``; K3 ``gather_attend``, K5
``log_mel_fused`` and K2′ ``permute_append_sharded``, which a
single-process engine does not run, must count 0), found in the trace by
each kernel's symbol (its module's ``KERNEL_SYMBOL``; K2′'s
``SHARDED_KERNEL_SYMBOL``). It exits non-zero if the trace's count of an
own kernel differs from its wrapper's ``launches`` count over the stage.
``--beam``, ``--quantization``
and ``--kv-cache-dtype`` select the beam path (its step mode is the
engine's "auto": K2's "hybrid" on the card). The last line is one JSON
object with those numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _own_kernels() -> dict:
    """{name: (symbol in the trace, the wrapper's launch count now)}."""
    from whisper_tpu_torch.frontend import mel_fused
    from whisper_tpu_torch.ops import (attention, cross_attend, fp8_upcast, fused_step, gather,
                                       gather_attend)

    own = {m.KERNEL: (m.KERNEL_SYMBOL, m.launches)
           for m in (attention, fused_step, gather, gather_attend, mel_fused, fp8_upcast, cross_attend)}
    own[fused_step.SHARDED_KERNEL] = (fused_step.SHARDED_KERNEL_SYMBOL, fused_step.sharded_launches)
    return own


def _stage(torch, fn, label: str, top: int = 8) -> dict:
    from torch.profiler import ProfilerActivity, profile

    before = {name: n for name, (_, n) in _own_kernels().items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in kernels) / 1e3  # device_time is µs
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    own = {}
    for kernel, (symbol, now) in _own_kernels().items():
        hits = [(n, t) for name, (n, t) in by_name.items() if symbol in name]
        count, ms = sum(n for n, _ in hits), sum(t for _, t in hits)
        launched = now - before[kernel]
        if count != launched:
            sys.exit(f"profile_path: [{label}] the trace holds {count} launches of "
                     f"{kernel} ({symbol}*), its wrapper counted {launched}")
        own[kernel] = {"count": count, "ms": ms, "share": ms / dev_ms if dev_ms else 0.0}
    print(
        f"[{label}] wall {wall_ms:.1f} ms, device kernels {dev_ms:.1f} ms "
        f"(busy {dev_ms / wall_ms:.1%}), {len(kernels)} kernel launches"
    )
    for name, (n, t) in ranked:
        print(f"    {t:9.2f} ms {n:6d}x  {name[:110]}")
    for key, v in own.items():
        if v["count"]:
            print(f"    own kernel {key}: {v['ms']:.2f} ms over {v['count']} launches ({v['share']:.1%} of device time)")
    return {
        "wall_ms": wall_ms, "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
        "launches": len(kernels), "own_kernels": own,
        "top": [{"name": k[:110], "count": n, "ms": t} for k, (n, t) in ranked],
    }, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32, help="decode token budget")
    ap.add_argument("--beam", type=int, default=1, help="beam size (1: greedy)")
    ap.add_argument("--quantization", default=None, choices=[None, "int8"])
    ap.add_argument("--kv-cache-dtype", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_path: needs a CUDA card")
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import beam
    from whisper_tpu_torch.engine import EngineType, create_engine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = EngineConfig(
        model=args.model, max_new_tokens=args.steps, beam_size=args.beam,
        quantization=args.quantization, kv_cache_dtype=args.kv_cache_dtype,
    )
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    batch = (0.1 * rng.standard_normal((args.batch, 480_000))).astype(np.float32)
    engine.transcribe_batch(batch)  # warm-up: library handles, allocator

    host, _, _ = engine._prepare_batch(batch)
    enc, enc_out = _stage(torch, lambda: engine._encode(host, engine._resolve_audio_ctx(host)), "mel+encoder")
    steps_before = beam.steps
    dec, (tokens, lengths, _, _) = _stage(torch, lambda: engine._decode(enc_out), "decode")
    if args.beam > 1:  # the beam loop may stop before its longest hypothesis' end
        steps = beam.steps - steps_before
    else:
        steps = int(lengths.max().item()) - len(engine._prompt)
    print(
        f"decode: {steps} steps, {dec['wall_ms'] / steps:.2f} ms/step wall, "
        f"{dec['device_ms'] / steps:.2f} ms/step on the device, "
        f"{dec['launches'] / steps:.0f} launches/step"
    )
    print(card)
    print(json.dumps({
        "card": card, "model": args.model, "batch": args.batch, "beam": args.beam,
        "quantization": args.quantization, "kv_cache_dtype": args.kv_cache_dtype,
        "decode_steps": steps,
        "encoder": enc, "decode": dec,
    }))


if __name__ == "__main__":
    main()
