"""One rank of a data-parallel run, as its own process.

    python -m whisper_tpu_torch.parallel._dist_worker --coordinator HOST:PORT \\
        --num-processes N --process-id I (--paths F1,F2,... | --npy BATCH.npy) \\
        --out RESULT.json [--model large-v3] [--seed 0 | --params PARAMS.pt] \\
        [--device cuda] [--dtype bfloat16] [--beam 5] [--quantization int8] \\
        [--kv-cache-dtype float8_e4m3fn] [--fused-step auto[,off]] [--max-new 64] \\
        [--fallback] [--word-timestamps] [--threads 0]

Counterpart of ``whisper_tpu/parallel/_dist_worker.py``. Under ``torchrun
--nproc-per-node N -m whisper_tpu_torch.parallel._dist_worker ...`` the
first three options are left out (``parallel.initialize`` reads the
launcher's environment); ``{rank}`` in ``--out`` becomes the rank.

The rank joins a gloo world of N processes, stands up the engine through
``create_engine`` with ``mesh_shape=(N, 1)``, and runs either
``transcribe_files`` over ``--paths`` (each rank reads only its files; then
a pass over the first file alone, where every rank but the first holds only
padding) or ``transcribe_batch`` over the [B, n] float32 array in ``--npy``
(every rank holds it and decodes its share). Weights come from ``--seed``
(``from_random`` on ``--device``) or from ``--params``, a tree saved with
``torch.save`` (e.g. ``params_from_jax`` of the JAX package's weights).
``--fused-step`` may list several beam step modes; each runs on the same
weights. ``--fallback`` adds a retry ladder (0.5 after the primary) behind
a logprob gate no decode clears, so that every row walks the whole ladder
(on ``--paths``, through the multi-process ladder). ``--word-timestamps``
turns on the alignment forward (each rank aligns its rows; not on the
``--paths`` pass, as in JAX). For each, the gathered results (tokens up to
their length, lengths, text, avg_logprob, no-speech probabilities,
temperature and compression ratio, words as ``[word, start, end]``) and
this rank's
launches of K1, K2, K2′ and K4 over that run go to ``--out`` as JSON, with a
checksum of the rank's weights. float32 stays float32 on the card (TF32
off), so that its runs can be held against the CPU's.

:func:`launch` starts N such ranks on this host and returns their reports.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parents[2]  # the directory that holds the package


def launch(n: int, args: Sequence[str], out_dir: str, timeout: float = 120.0) -> List[dict]:
    """Run ``n`` ranks of this worker on this host, a gloo world over a free
    localhost port, with the worker options ``args`` (everything but the
    world's and ``--out``). Returns the ranks' reports in rank order.
    Raises with the ends of their output if a rank fails or outlives
    ``timeout`` seconds; no rank outlives the call."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(_REPO), os.environ.get("PYTHONPATH")) if p))
    outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(n)]
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as log:  # the child keeps its own handle
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "whisper_tpu_torch.parallel._dist_worker",
                     "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                     "--process-id", str(r), "--out", outs[r], *args],
                    cwd=_REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if len(procs) != n or any(codes):
        tails = [Path(f).read_text()[-3000:] for f in logs if os.path.exists(f)]
        raise RuntimeError(
            f"data-parallel workers failed (exit codes {codes}, killed after {timeout} s "
            f"if negative): {tails}"
        )
    reports = []
    for path in outs:
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def params_checksum(params) -> str:
    """Sum of every weight in float64, as text: equal on every rank when the
    ranks hold the same bytes."""
    import torch

    from whisper_tpu_torch.models.params import leaves

    return repr(sum(float(t.to(torch.float64).sum()) for t in leaves(params)))


def _rows(results) -> list:
    return [
        {
            "tokens": [int(t) for t in r.tokens[: r.length]],
            "length": int(r.length),
            "text": r.text,
            "avg_logprob": r.avg_logprob,
            "no_speech_prob": r.no_speech_prob,
            "temperature": r.temperature,
            "compression_ratio": r.compression_ratio,
            "words": None if r.words is None else [[w.word, w.start, w.end] for w in r.words],
        }
        for r in results
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--paths", help="comma-separated audio files: transcribe_files")
    src.add_argument("--npy", help="a [B, n] float32 batch: transcribe_batch")
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="dev")
    weights = ap.add_mutually_exclusive_group()
    weights.add_argument("--seed", type=int, default=0)
    weights.add_argument("--params", default=None, help="torch.save'd parameter tree")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--beam", type=int, default=1)
    ap.add_argument("--quantization", default=None, choices=[None, "int8"])
    ap.add_argument("--kv-cache-dtype", default=None)
    ap.add_argument("--fused-step", default="auto", help="beam step modes, comma-separated")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--fallback", action="store_true",
                    help="a retry ladder behind a gate no decode clears")
    ap.add_argument("--word-timestamps", action="store_true")
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: default)")
    args = ap.parse_args()

    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.decode import beam
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.ops import attention, fused_step, gather
    from whisper_tpu_torch.parallel.multihost import initialize, rank, world_size

    initialize(args.coordinator, args.num_processes, args.process_id)
    cfg = EngineConfig(
        model=args.model, dtype=args.dtype, beam_size=args.beam,
        quantization=args.quantization, kv_cache_dtype=args.kv_cache_dtype,
        max_new_tokens=args.max_new, mesh_shape=(world_size(), 1),
        word_timestamps=args.word_timestamps,
    )
    if args.fallback:
        cfg = dataclasses.replace(
            cfg, fallback_temperatures=(0.5,), logprob_threshold=1e9,
            compression_ratio_threshold=None,
        )
    params = None
    if args.params:
        params = torch.load(args.params, map_location="cpu", weights_only=True)
    engine = create_engine(
        EngineType.MONOLITH, cfg, params=params, seed=args.seed, device=args.device
    )
    if args.npy:
        batch = np.load(args.npy)
        crop = engine._resolve_audio_ctx(engine._prepare_batch(batch)[0])
    else:
        paths = args.paths.split(",")
        crop = engine._resolve_audio_ctx(None)

    runs = {}
    for mode in args.fused_step.split(","):
        fused = {"true": True, "false": False}.get(mode.lower(), mode)
        eng = type(engine)(
            engine.assets, dataclasses.replace(cfg, fused_step=fused), device=args.device
        )
        for m in (attention, fused_step, gather):
            m.launches = 0
        fused_step.sharded_launches = 0
        beam.steps = 0  # counts start here: this mode's run
        t0 = time.perf_counter()
        results = eng.transcribe_batch(batch) if args.npy else eng.transcribe_files(paths)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        seconds = time.perf_counter() - t0
        run = {
            "results": _rows(results),
            "launches": {
                "flash_attn_fwd": attention.launches,
                "permute_append": fused_step.launches,
                "permute_append_sharded": fused_step.sharded_launches,
                "permute_rows": gather.launches,
            },
            "steps": beam.steps,  # counts end here
            "encodes": 1,
            "seconds": seconds,
        }
        if not args.npy:
            # The one-file pass: every rank but the first holds only padding
            # and must still run and join every gather.
            probe, _, _ = eng._mp_pass(paths[:1])
            run["probe_single"] = [int(t) for t in probe[0][0][: probe[0][1]]]
        runs[str(mode)] = run

    with open(args.out.format(rank=rank()), "w") as f:
        json.dump(
            {
                "rank": rank(),
                "world": world_size(),
                "device": str(engine.device),
                "device_name": (
                    torch.cuda.get_device_name(engine.device)
                    if engine.device.type == "cuda" else "cpu"
                ),
                "params_checksum": params_checksum(engine.assets.params),
                "audio_ctx": crop,
                "runs": runs,
            },
            f,
        )
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
