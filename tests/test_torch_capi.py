"""The port's C-ABI engine binding (``whisper_tpu_torch/native/
whisper_engine_capi.cpp``) and its C driver, the counterpart of
``tests/test_capi.py``.

Built here with g++ against this interpreter (``native.build.build_engine``),
into the port's own build directory. Two call paths, both on
``device="cpu"`` at ``dev`` f32:

* ctypes from inside this process (the library joins the running
  interpreter): a buffer and a file transcribed, each text equal to the
  in-process engine's; a missing file gives NULL and a message, and the
  engine stays usable;
* the C driver as a subprocess (a foreign process that embeds Python):
  its printed text equals the in-process engine's.
"""

import ctypes
import os
import site
import subprocess

import numpy as np
import pytest
import torch

from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.native.build import build_engine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The repo and this interpreter's packages: the C driver's embedded
# interpreter starts from the base installation.
PYTHONPATH = ":".join([REPO, *site.getsitepackages()])
CONFIG = {"model": "dev", "language": "en", "dtype": "float32", "max_new_tokens": 4}


def _config_json(**extra) -> str:
    import json

    return json.dumps({**CONFIG, "device": "cpu", "pythonpath": PYTHONPATH, **extra})


@pytest.fixture(scope="module")
def built():
    return build_engine()


@pytest.fixture(scope="module")
def engine():
    return create_engine(EngineType.MONOLITH, EngineConfig(**CONFIG), seed=0, device="cpu")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.default_rng(0)
    p = str(tmp_path_factory.mktemp("capi") / "u.wav")
    write_wav(p, (0.1 * rng.standard_normal(12_000)).astype(np.float32))
    return p


def test_ctypes_attach_buffer_file_and_errors(built, engine, wav):
    lib = ctypes.CDLL(built["engine"])
    lib.wh_engine_create.restype = ctypes.c_void_p
    lib.wh_engine_create.argtypes = [ctypes.c_char_p]
    lib.wh_engine_transcribe_buffer.restype = ctypes.c_void_p
    lib.wh_engine_transcribe_buffer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    lib.wh_engine_transcribe_file.restype = ctypes.c_void_p
    lib.wh_engine_transcribe_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wh_engine_error.restype = ctypes.c_char_p
    lib.wh_engine_string_free.argtypes = [ctypes.c_void_p]
    lib.wh_engine_destroy.argtypes = [ctypes.c_void_p]

    handle = lib.wh_engine_create(_config_json().encode())
    assert handle, lib.wh_engine_error().decode()

    def text_of(ptr):
        assert ptr, lib.wh_engine_error().decode()
        out = ctypes.string_at(ptr).decode()
        lib.wh_engine_string_free(ptr)
        return out

    samples = (0.1 * np.random.default_rng(0).standard_normal(12_000)).astype(np.float32)
    buf = lib.wh_engine_transcribe_buffer(
        handle, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(samples)
    )
    assert text_of(buf) == engine.transcribe(samples).text
    assert text_of(lib.wh_engine_transcribe_file(handle, wav.encode())) == engine.transcribe(wav).text

    assert not lib.wh_engine_transcribe_file(handle, b"/nonexistent.wav")
    assert lib.wh_engine_error()
    assert text_of(lib.wh_engine_transcribe_file(handle, wav.encode()))  # still usable
    lib.wh_engine_destroy(handle)

    # A bad config: NULL and the engine's own message.
    assert not lib.wh_engine_create(_config_json(beam_size=2, temperature=0.5).encode())
    assert b"temperature" in lib.wh_engine_error()


def test_c_driver_subprocess_equals_the_engine(built, engine, wav):
    out = subprocess.run(
        [built["driver"], _config_json(), wav], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == engine.transcribe(wav).text + "\n"
    assert out.stdout.strip()  # dev's vocabulary prints <|eN|> surfaces


def test_c_driver_reports_a_failure(built, wav):
    out = subprocess.run(
        [built["driver"], _config_json(model="nope"), wav], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 1 and "create failed" in out.stderr
