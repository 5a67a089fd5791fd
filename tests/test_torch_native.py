"""The port's native host loader (``whisper_tpu_torch/native``) against its
Python readers and against JAX's ``whisper_tpu.native``.

The library is built here with g++ (``native.build.build_host``) from the
unchanged ``native/whisper_host.cpp``, into the port's own build directory.
Its readers and batch loader must give the Python readers' samples
bitwise, and JAX's binding over the same library the same bytes as the
port's; frame energies agree with numpy to rtol 1e-7 (another summation
order), as in ``tests/test_native.py``. The loader is wired into
``read_files``, ``load_files_sharded`` and ``Engine.transcribe_files``:
each gives the same rows with and without it.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

import whisper_tpu.native as jax_native
import whisper_tpu_torch.native as native_mod
from whisper_tpu_torch.audio.vad import energy_vad, frame_energies, remove_silence
from whisper_tpu_torch.audio.wav import read_pcm_f32, read_wav, read_wav_legacy, write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.native.build import build_host
from whisper_tpu_torch.parallel import multihost
from whisper_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def host():
    path = build_host()
    native_mod.load_native.cache_clear()
    loaded = native_mod.load_native()
    assert loaded is not None and loaded.path == path
    return loaded


@pytest.fixture(scope="module")
def jax_host(host):
    """JAX's binding over the same library."""
    return jax_native.NativeHost(ctypes.CDLL(host.path), host.path)


@pytest.fixture(scope="module")
def speechy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=32_000).astype(np.float32) * 0.002
    t = np.arange(8_000) / 16_000
    burst = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    x[1000 : 1000 + len(burst)] += burst
    x[20000 : 20000 + len(burst)] += burst
    return x


def _stereo(path, rng):
    pcm = (rng.normal(size=32000) * 8000).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 16000, 64000, 4, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def _float_wav(path, rng):
    x = rng.normal(size=16000).astype("<f4")
    data = x.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def _same(a, b, c):
    assert a.dtype == b.dtype == c.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_readers_bitwise(host, jax_host, tmp_path, speechy):
    rng = np.random.default_rng(1)
    mono, stereo, flt, pcm = (str(tmp_path / n) for n in ("m.wav", "s.wav", "f.wav", "x.pcm"))
    write_wav(mono, speechy)
    _stereo(stereo, rng)
    _float_wav(flt, rng)
    speechy.astype("<f4").tofile(pcm)
    for p in (mono, stereo, flt):
        _same(host.read_wav(p), read_wav(p), jax_host.read_wav(p))
    _same(host.read_wav(stereo, reference_quirks=True), read_wav(stereo, reference_quirks=True),
          jax_host.read_wav(stereo, reference_quirks=True))
    _same(host.read_wav_legacy(mono), read_wav_legacy(mono), jax_host.read_wav_legacy(mono))
    _same(host.read_pcm_f32(pcm), read_pcm_f32(pcm), jax_host.read_pcm_f32(pcm))


def test_readers_refuse_as_jax(host, tmp_path, speechy):
    p = str(tmp_path / "r.wav")
    write_wav(p, speechy, sample_rate=8000)
    with pytest.raises(ValueError, match="sample rate"):
        host.read_wav(p)
    g = str(tmp_path / "g.wav")
    with open(g, "wb") as f:
        f.write(b"not a wav at all")
    with pytest.raises(ValueError):
        host.read_wav(g)


def test_vad_loops(host, jax_host, speechy):
    np.testing.assert_allclose(host.frame_energies(speechy), frame_energies(speechy), rtol=1e-7)
    np.testing.assert_array_equal(host.frame_energies(speechy), jax_host.frame_energies(speechy))
    _same(host.energy_vad(speechy).astype(np.float32), energy_vad(speechy).astype(np.float32),
          jax_host.energy_vad(speechy).astype(np.float32))
    _same(host.remove_silence(speechy), remove_silence(speechy), jax_host.remove_silence(speechy))
    assert host.frame_energies(np.zeros(10, np.float32)).size == 0


def _files(tmp_path, n=6):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"b{i}.wav")
        write_wav(p, rng.normal(size=8000 + 1000 * i).astype(np.float32) * 0.1)
        paths.append(p)
    return paths


def test_load_batch_bitwise(host, jax_host, tmp_path):
    paths = _files(tmp_path)
    batch = host.load_batch(paths, max_len=16000, n_threads=3)
    assert batch.shape == (6, 16000)
    np.testing.assert_array_equal(batch, jax_host.load_batch(paths, max_len=16000, n_threads=3))
    for i, p in enumerate(paths):
        ref = read_wav(p)
        np.testing.assert_array_equal(batch[i, : len(ref)], ref)
        assert not batch[i, len(ref) :].any()
    np.testing.assert_array_equal(host.load_batch(paths[:1], max_len=1000)[0], read_wav(paths[0])[:1000])
    with pytest.raises(ValueError, match="cannot open"):
        host.load_batch([str(tmp_path / "missing.wav")], max_len=100)


def test_callers_read_the_same_rows_with_and_without_the_loader(host, tmp_path, monkeypatch):
    paths = _files(tmp_path, 3)
    with_native = multihost.read_files(paths, 16000)
    mesh = Mesh({"data": 4, "model": 1}, ("data", "model"), 0, torch.device("cpu"))
    sharded, _ = multihost.load_files_sharded(paths, mesh, max_len=16000)
    # Without the library, the Python readers read them.
    monkeypatch.setattr(native_mod, "load_native", lambda: None)
    without = multihost.read_files(paths, 16000)
    sharded_py, _ = multihost.load_files_sharded(paths, mesh, max_len=16000)
    np.testing.assert_array_equal(with_native, without)
    np.testing.assert_array_equal(sharded, sharded_py)


def test_transcribe_files_with_and_without_the_loader(host, tmp_path, monkeypatch):
    paths = _files(tmp_path, 3)
    engine = create_engine(
        EngineType.MONOLITH, EngineConfig(model="dev", dtype="float32", max_new_tokens=4),
        seed=0, device="cpu",
    )
    calls = []
    real = host.load_batch
    monkeypatch.setattr(host, "load_batch", lambda *a, **k: calls.append(1) or real(*a, **k))
    with_native = engine.transcribe_files(paths)
    assert calls  # the loader read them
    monkeypatch.setattr(native_mod, "load_native", lambda: None)
    without = engine.transcribe_files(paths)
    assert [(r.tokens.tolist(), r.text) for r in with_native] == [
        (r.tokens.tolist(), r.text) for r in without
    ]
