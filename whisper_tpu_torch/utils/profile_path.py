"""Where the time goes on the port's main path, on one CUDA card.

    python3 -m whisper_tpu_torch.utils.profile_path [--model large-v3] [--batch 4] [--steps 32]

Builds a random-weight ``whisper_tpu_torch`` MONOLITH engine on the card,
warms it with one ``transcribe_batch``, then traces the encoder stage and
the decode stage separately with ``torch.profiler`` (CPU + CUDA
activities). For each stage it prints the host wall time, the summed
device-kernel time, the device busy share (kernel time / wall; kernels run
on one stream, so their sum is the busy time), the kernel launch count, and
the kernels that take the most device time. The last line is one JSON
object with those numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _stage(torch, fn, label: str, top: int = 8) -> dict:
    from torch.profiler import ProfilerActivity, profile

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
    print(
        f"[{label}] wall {wall_ms:.1f} ms, device kernels {dev_ms:.1f} ms "
        f"(busy {dev_ms / wall_ms:.1%}), {len(kernels)} kernel launches"
    )
    for name, (n, t) in ranked:
        print(f"    {t:9.2f} ms {n:6d}x  {name[:110]}")
    return {
        "wall_ms": wall_ms, "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
        "launches": len(kernels),
        "top": [{"name": k[:110], "count": n, "ms": t} for k, (n, t) in ranked],
    }, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32, help="decode token budget")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_path: needs a CUDA card")
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = EngineConfig(model=args.model, max_new_tokens=args.steps)
    engine = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    batch = (0.1 * rng.standard_normal((args.batch, 480_000))).astype(np.float32)
    engine.transcribe_batch(batch)  # warm-up: library handles, allocator

    host, _, _ = engine._prepare_batch(batch)
    enc, enc_out = _stage(torch, lambda: engine._encode(host), "mel+encoder")
    dec, (tokens, lengths, _) = _stage(torch, lambda: engine._decode(enc_out), "decode")
    steps = int(lengths.max().item()) - len(engine._prompt)
    print(
        f"decode: {steps} steps, {dec['wall_ms'] / steps:.2f} ms/step wall, "
        f"{dec['device_ms'] / steps:.2f} ms/step on the device, "
        f"{dec['launches'] / steps:.0f} launches/step"
    )
    print(card)
    print(json.dumps({
        "card": card, "model": args.model, "batch": args.batch, "decode_steps": steps,
        "encoder": enc, "decode": dec,
    }))


if __name__ == "__main__":
    main()
