"""Build the port's native libraries: ``python -m whisper_tpu_torch.native.build``.

Counterpart of ``whisper_tpu/native/build.py``, with g++ only, into
``build/whisper_tpu_torch/native/`` at the root of the checkout (never the
JAX package's ``native/build/``):

* ``libwhisper_host.so`` from the unchanged ``native/whisper_host.cpp``:
  the host loader that ``native.load_native`` binds;
* ``libwhisper_engine.so`` from ``whisper_engine_capi.cpp`` beside this
  file: the C-ABI engine binding, which embeds CPython, so it compiles
  against the running interpreter's include directory and links with
  ``python3-config --embed --ldflags``;
* ``whisper_driver`` from ``whisper_driver.c`` beside this file, linked to
  the engine library.

A target is rebuilt when its source is newer; ``--force`` rebuilds every
one. The paths built are printed, one per line.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
from typing import Dict, List

from whisper_tpu_torch.native import BUILD_DIR, HOST_LIB

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))
ENGINE_LIB = "libwhisper_engine.so"
DRIVER = "whisper_driver"


def _compiler() -> str:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    return gxx


def _fresh(out: str, *srcs: str) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs
    )


def _compile(cmd: List[str], out: str) -> None:
    """Run the compiler ``cmd`` (which ends in its inputs and flags) into a
    file of this process's own, then move it to ``out`` in one step, so that
    a process loading ``out`` never sees a half-written file."""
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{shlex.join(cmd)} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def python_embed_flags() -> Dict[str, List[str]]:
    """Compile and link flags for a library that embeds this interpreter:
    its include directory, and ``python3-config --embed --ldflags`` (the
    ``python3-config`` beside the interpreter, else the one on PATH, else
    ``sysconfig``'s library directory), with a run path to that directory."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h is not in {include}: the C-ABI binding cannot be built")
    config = os.path.join(os.path.dirname(sys.executable), "python3-config")
    if not os.path.exists(config):
        config = shutil.which("python3-config")
    if config:
        ldflags = shlex.split(
            subprocess.run([config, "--embed", "--ldflags"], capture_output=True,
                           text=True, check=True).stdout
        )
    else:
        ver = sysconfig.get_config_var("LDVERSION")
        ldflags = [f"-L{sysconfig.get_config_var('LIBDIR')}", f"-lpython{ver}", "-ldl", "-lm"]
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return {"cflags": [f"-I{include}"], "ldflags": ldflags + rpaths}


def build_host(force: bool = False) -> str:
    """Build (if needed) ``libwhisper_host.so``; returns its path."""
    src = os.path.join(REPO, "native", "whisper_host.cpp")
    out = os.path.join(BUILD_DIR, HOST_LIB)
    if force or not _fresh(out, src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        _compile([_compiler(), "-std=c++17", "-O3", "-shared", "-fPIC", "-fvisibility=hidden",
                  "-Wall", "-Wextra", src, "-lpthread"], out)
    return out


def build_engine(force: bool = False) -> Dict[str, str]:
    """Build (if needed) the C-ABI library and its driver; returns their
    paths as ``{"engine": ..., "driver": ...}``."""
    src = os.path.join(_HERE, "whisper_engine_capi.cpp")
    driver_src = os.path.join(_HERE, "whisper_driver.c")
    lib = os.path.join(BUILD_DIR, ENGINE_LIB)
    driver = os.path.join(BUILD_DIR, DRIVER)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if force or not _fresh(lib, src):
        flags = python_embed_flags()
        _compile([_compiler(), "-std=c++17", "-O2", "-shared", "-fPIC", "-fvisibility=hidden",
                  "-Wall", "-Wextra", *flags["cflags"], src, *flags["ldflags"]], lib)
    if force or not _fresh(driver, driver_src, lib):
        _compile([_compiler(), "-x", "c", "-O2", "-Wall", driver_src, "-x", "none",
                  f"-L{BUILD_DIR}", "-lwhisper_engine", "-Wl,-rpath,$ORIGIN"], driver)
    return {"engine": lib, "driver": driver}


def build(force: bool = False) -> Dict[str, str]:
    """Build the host library, the C-ABI library and its driver. Returns
    ``{"host": ..., "engine": ..., "driver": ...}``."""
    return {"host": build_host(force), **build_engine(force)}


if __name__ == "__main__":
    for path in build(force="--force" in sys.argv).values():
        print(path)
