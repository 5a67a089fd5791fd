"""ctypes bindings for the native host runtime (``native/whisper_host.cpp``).

Counterpart of ``whisper_tpu/native/__init__.py``, over the same unchanged
C++ source: WAV and raw-PCM decode, the VAD and silence frame loops, and
the multithreaded batch loader that fills one contiguous [B, 480000]
buffer (``load_batch``). Python stays the API surface. This is host I/O,
not a device kernel.

The library is built by ``python -m whisper_tpu_torch.native.build`` (g++)
into ``build/whisper_tpu_torch/native/`` at the root of the checkout, a
directory of the port's own. :func:`load_native` returns None while it is
not built, and callers then use the Python readers (``audio/wav.py``,
``audio/vad.py``), which give the same samples bitwise
(``tests/test_torch_native.py``). ``$WHISPER_TPU_TORCH_NATIVE_LIB`` names
another library file.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional, Sequence

import numpy as np

_ERR_LEN = 512
# Where native/build.py puts its libraries: build/ at the root of the checkout.
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "whisper_tpu_torch", "native",
)
HOST_LIB = "libwhisper_host.so"


def _candidate_paths() -> List[str]:
    explicit = os.environ.get("WHISPER_TPU_TORCH_NATIVE_LIB")
    return ([explicit] if explicit else []) + [os.path.join(BUILD_DIR, HOST_LIB)]


class NativeHost:
    """Typed wrapper over the wh_* C ABI."""

    def __init__(self, lib: ctypes.CDLL, path: str):
        self._lib = lib
        self.path = path
        c = ctypes.c_char_p
        i32, i64 = ctypes.c_int, ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.wh_version.restype = i32
        lib.wh_free.argtypes = [f32p]
        lib.wh_wav_read.restype = i32
        lib.wh_wav_read.argtypes = [c, i32, i32, ctypes.POINTER(f32p),
                                    ctypes.POINTER(i64), ctypes.c_char_p, i32]
        lib.wh_wav_read_legacy.restype = i32
        lib.wh_wav_read_legacy.argtypes = [c, ctypes.POINTER(f32p),
                                           ctypes.POINTER(i64), ctypes.c_char_p, i32]
        lib.wh_pcm_read_f32.restype = i32
        lib.wh_pcm_read_f32.argtypes = lib.wh_wav_read_legacy.argtypes
        lib.wh_frame_energies.restype = i64
        lib.wh_frame_energies.argtypes = [f32p, i64, i64, f32p]
        lib.wh_energy_vad.restype = i64
        lib.wh_energy_vad.argtypes = [f32p, i64, i64, ctypes.c_float, u8p]
        lib.wh_remove_silence.restype = i64
        lib.wh_remove_silence.argtypes = [f32p, i64, i64, ctypes.c_float, f32p]
        lib.wh_load_batch.restype = i32
        lib.wh_load_batch.argtypes = [ctypes.POINTER(c), i32, f32p, i64, i32,
                                      i32, i32, ctypes.c_char_p, i32]

    @property
    def version(self) -> int:
        return int(self._lib.wh_version())

    def _take(self, ptr, n) -> np.ndarray:
        try:
            out = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()
        finally:
            self._lib.wh_free(ptr)
        return out

    def read_wav(
        self, path: str, expected_sample_rate: Optional[int] = 16_000,
        reference_quirks: bool = False,
    ) -> np.ndarray:
        ptr = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.wh_wav_read(
            path.encode(), expected_sample_rate or 0, int(reference_quirks),
            ctypes.byref(ptr), ctypes.byref(n), err, _ERR_LEN,
        )
        if rc != 0:
            raise ValueError(err.value.decode())
        return self._take(ptr, n)

    def read_wav_legacy(self, path: str) -> np.ndarray:
        ptr = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.wh_wav_read_legacy(
            path.encode(), ctypes.byref(ptr), ctypes.byref(n), err, _ERR_LEN
        )
        if rc != 0:
            raise ValueError(err.value.decode())
        return self._take(ptr, n)

    def read_pcm_f32(self, path: str) -> np.ndarray:
        ptr = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.wh_pcm_read_f32(
            path.encode(), ctypes.byref(ptr), ctypes.byref(n), err, _ERR_LEN
        )
        if rc != 0:
            raise ValueError(err.value.decode())
        return self._take(ptr, n)

    def frame_energies(self, samples: np.ndarray, frame_size: int = 512) -> np.ndarray:
        x = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.zeros(len(x) // frame_size, dtype=np.float32)
        if out.size:
            self._lib.wh_frame_energies(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                frame_size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        return out

    def energy_vad(
        self, samples: np.ndarray, threshold: float = 0.01, frame_size: int = 512
    ) -> np.ndarray:
        x = np.ascontiguousarray(samples, dtype=np.float32)
        mask = np.zeros(len(x) // frame_size, dtype=np.uint8)
        if mask.size:
            self._lib.wh_energy_vad(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                frame_size, threshold,
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        return mask.astype(bool)

    def remove_silence(
        self, samples: np.ndarray, threshold_db: float = -35.0,
        frame_size: int = 512,
    ) -> np.ndarray:
        x = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.zeros((len(x) // frame_size) * frame_size, dtype=np.float32)
        written = 0
        if out.size:
            written = self._lib.wh_remove_silence(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                frame_size, threshold_db,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        return out[:written]

    def load_batch(
        self,
        paths: Sequence[str],
        max_len: int = 480_000,
        expected_sample_rate: Optional[int] = 16_000,
        legacy: bool = False,
        n_threads: int = 0,
        strict: bool = True,
    ) -> np.ndarray:
        """Parallel decode+pad into one contiguous [B, max_len] buffer."""
        out = np.zeros((len(paths), max_len), dtype=np.float32)
        if not paths:
            return out
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        err = ctypes.create_string_buffer(_ERR_LEN)
        failures = self._lib.wh_load_batch(
            arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_len, expected_sample_rate or 0, int(legacy), n_threads,
            err, _ERR_LEN,
        )
        if failures and strict:
            raise ValueError(
                f"{failures} file(s) failed; first: {err.value.decode()}"
            )
        return out


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[NativeHost]:
    """The native library if it is built, else None (callers then read with
    the Python readers). Cached: after a build, ``load_native.cache_clear()``."""
    for path in _candidate_paths():
        if os.path.exists(path):
            try:
                return NativeHost(ctypes.CDLL(path), path)
            except OSError:
                continue
    return None
