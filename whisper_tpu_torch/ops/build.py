"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc
for ``sm_90a`` into a shared library under ``build/whisper_tpu_torch/`` at
the root of the checkout and loaded with ``ctypes``. The library's file
name carries a hash of its source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source is built
anew and a stale library is never loaded. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "whisper_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # The shared headers go into every hash: an edited header rebuilds all.
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: List[str]) -> dict:
    """Compile every named source that has no library yet, one nvcc process
    per source, all started together. Returns {name: (seconds, ptxas log)};
    raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib, time.perf_counter())
    out = {}
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
        out[name] = (time.perf_counter() - t0, log)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(_target(name)[1]))
