"""Multi-rank dry run: the whole pipeline on (data, model) meshes of gloo
ranks, held token for token against one process.

Counterpart of ``whisper_tpu/parallel/dryrun.py``. JAX stands up one
program over n virtual devices; the port runs one process per rank
(``parallel/_dist_worker.py``), so each mesh is a world of n processes on
this host: CPU ranks by default, or ranks that share the card
(``device="cuda"``; several ranks on one card prove the arithmetic, not a
speed). It covers the parallelism JAX's dry run covers:

* **dp**: the utterance batch split over the ``data`` axis;
* **tp**: Megatron head and MLP sharding over the ``model`` axis
  (``parallel/sharding.py``), with the collectives the layers place;
* sequence and expert parallelism are absent by design, as in JAX: the
  encoder's 1500 positions and the 448 text positions are fixed, and
  there is no mixture of experts.

:func:`dryrun_multichip` runs JAX's matrix over the meshes (1, 1), (n, 1)
and (n/2, 2), with ``create_engine`` and ``mesh_shape`` in the config, as a
user gets them from the CLI's ``--mesh``. Raises on any difference.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, List, Sequence

import numpy as np


def _tokens_of(results) -> List[List[int]]:
    return [[int(t) for t in r.tokens[: r.length]] for r in results]


@contextlib.contextmanager
def _no_tf32(device: str):
    """float32 stays float32 on the card while the ``with`` lasts, as it
    does in every worker."""
    import torch

    if device != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mesh_shapes(n: int) -> List[tuple]:
    """The meshes of n ranks that the dry run compares with one process."""
    shapes = [(n, 1)]
    if n % 2 == 0 and n > 1:
        shapes.append((n // 2, 2))
    return shapes


_FLAGS = {
    "beam_size": "--beam", "max_new_tokens": "--max-new", "quantization": "--quantization",
    "kv_cache_dtype": "--kv-cache-dtype", "draft_model": "--draft-model", "k_draft": "--k-draft",
    "language": "--language",
}


def _mesh_parity(
    n: int, model: str, npy: str, device: str, workdir: str,
    modes: Sequence = ("auto",), timeout: float = 600.0, **extra,
) -> Dict[str, List[List[int]]]:
    """The same batch through ``create_engine`` in this process and on the
    meshes of :func:`mesh_shapes`, for each beam step mode in ``modes``
    (each run on the same weights: ``seed=0``). Every rank of every mesh
    must return the single process's tokens. Returns them by mode."""
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.parallel._dist_worker import launch

    cfg = {"language": "de", "max_new_tokens": 4, **extra}
    samples = np.load(npy)
    reference = {}
    with _no_tf32(device):
        for mode in modes:
            eng = create_engine(
                EngineType.MONOLITH,
                EngineConfig(model=model, dtype="float32", fused_step=mode, **cfg),
                seed=0, device=device,
            )
            assert eng.mesh is None  # (1, 1): no mesh machinery, as in JAX
            toks = _tokens_of(eng.transcribe_batch(samples))
            assert len(toks) == samples.shape[0] and all(len(t) >= 4 for t in toks)
            reference[str(mode)] = toks
    args = ["--npy", npy, "--model", model, "--seed", "0", "--device", device,
            "--dtype", "float32", "--threads", "1",
            "--fused-step", ",".join(str(m).lower() for m in modes)]
    for key, value in cfg.items():
        if key in _FLAGS and value is not None:
            args += [_FLAGS[key], str(value)]
    for d, m in mesh_shapes(n):
        reports = launch(n, args + ["--mesh", f"{d},{m}"], workdir, timeout=timeout)
        for rep in reports:
            assert rep["mesh"] == [d, m]
            for mode in modes:
                got = [r["tokens"] for r in rep["runs"][str(mode).lower()]["results"]]
                if got != reference[str(mode)]:
                    raise AssertionError(
                        f"{model} {cfg} fused_step={mode!r}: rank {rep['rank']} of mesh "
                        f"{(d, m)} diverged from the single process: {got} != "
                        f"{reference[str(mode)]}"
                    )
    return reference


def _multiprocess_leg(n: int, device: str, workdir: str, timeout: float) -> None:
    """``transcribe_files`` over a shared file list on every mesh of n
    ranks (each data rank reads only its files): every rank's results equal
    a plain single-process engine's. A rank holds only its own rows there,
    so ``audio_ctx="auto"`` is the full window on every rank (as in JAX);
    the single process is pinned to the full window to crop alike."""
    from whisper_tpu_torch.audio.wav import write_wav
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.parallel._dist_worker import launch

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = os.path.join(workdir, f"u{i}.wav")
        write_wav(p, (0.1 * rng.standard_normal(12_000)).astype(np.float32))
        paths.append(p)
    with _no_tf32(device):
        plain = create_engine(
            EngineType.MONOLITH,
            EngineConfig(
                model="dev", language="en", max_new_tokens=4, dtype="float32", audio_ctx=None
            ),
            seed=0, device=device,
        )
        results = plain.transcribe_files(paths)
    expected = [
        {"tokens": t, "text": r.text, "temperature": r.temperature}
        for t, r in zip(_tokens_of(results), results)
    ]
    for d, m in mesh_shapes(n):
        reports = launch(n, [
            "--paths", ",".join(paths), "--model", "dev", "--seed", "0", "--device", device,
            "--dtype", "float32", "--language", "en", "--max-new", "4", "--threads", "1",
            "--mesh", f"{d},{m}",
        ], workdir, timeout=timeout)
        for rep in reports:
            got = [
                {k: r[k] for k in ("tokens", "text", "temperature")}
                for r in rep["runs"]["auto"]["results"]
            ]
            if got != expected:
                raise AssertionError(
                    f"transcribe_files: rank {rep['rank']} of mesh {(d, m)} diverged "
                    "from the single-process engine"
                )


def dryrun_multichip(
    n_devices: int, device: str = "cpu", dev_only: bool = False, timeout: float = 600.0
) -> None:
    """Stand up the product surface on worlds of ``n_devices`` ranks and
    hold every mesh of :func:`mesh_shapes` to one process, token for token:

    * ``dev`` and ``tiny``, greedy and beam 2 (``dev_only``: ``dev`` alone,
      and nothing below);
    * the flagship matrix at ``tiny``: beam 5, int8 weights, an fp8 KV
      cache, 9 tokens (``ctx_bucket`` is accepted and ignored: the port
      preallocates one cache);
    * ``fused_step=True``, which is "hybrid" (K2′) on the data-parallel
      mesh and "off" on the tensor-parallel one, and "lineage", which must
      equal the eager step ("off");
    * speculative decoding with a ``dev`` draft at k = 3, equal to plain
      greedy;
    * ``transcribe_files`` on every mesh against one process.

    Raises on any compile, layout or token difference."""
    rng = np.random.default_rng(0)
    batch = max(n_devices, 2)
    samples = (0.1 * rng.standard_normal((batch, 16_000))).astype(np.float32)
    with tempfile.TemporaryDirectory() as workdir:
        npy = os.path.join(workdir, "batch.npy")
        np.save(npy, samples)
        run = dict(n=n_devices, npy=npy, device=device, workdir=workdir, timeout=timeout)

        # dev geometry first: a cheap canary for the whole matrix.
        _mesh_parity(model="dev", beam_size=1, **run)
        _mesh_parity(model="dev", beam_size=2, **run)
        if dev_only:
            return

        # tiny geometry (384 wide, 6 heads, 4 layers, the real vocabulary).
        _mesh_parity(model="tiny", beam_size=1, **run)
        _mesh_parity(model="tiny", beam_size=2, **run)
        _mesh_parity(
            model="tiny", beam_size=5, max_new_tokens=9, quantization="int8",
            kv_cache_dtype="float8_e4m3fn", ctx_bucket=4, **run,
        )

        # fused_step=True (hybrid on dp, off on tp) and lineage against eager.
        ref = _mesh_parity(
            model="dev", beam_size=3, max_new_tokens=6, modes=("off", "lineage", True), **run
        )
        if not ref["off"] == ref["lineage"] == ref["True"]:
            raise AssertionError("lineage or fused_step=True diverged from the eager step")

        # Speculative decoding equals plain greedy on every layout.
        plain = _mesh_parity(model="dev", beam_size=1, max_new_tokens=6, **run)
        spec = _mesh_parity(
            model="dev", beam_size=1, max_new_tokens=6, draft_model="dev", k_draft=3, **run
        )
        if spec != plain:
            raise AssertionError("speculative decoding diverged from plain greedy on a mesh")

        _multiprocess_leg(n_devices, device, workdir, timeout)
