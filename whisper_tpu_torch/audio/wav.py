"""WAV / raw-PCM audio I/O (host side).

Covers the reference's two C++ readers (wav_util.cpp:18-87 legacy 44-byte
parser, wav_util.cpp:89-129 dr_wav-based) and the Java WaveUtil reader/writer
(WaveUtil.java:14-106) with one chunk-aware RIFF implementation.

Numeric contracts preserved:
* int16 → float scaling divides by 32767 (INT16_MAX — wav_util.cpp:73,119;
  WaveUtil.java uses 32768.0f, a known skew between the reference's own
  readers; we follow the C++ engines since they feed the golden outputs);
* stereo downmix averages channels. The C++ reader divides the int16 sum by
  INT32_MAX (wav_util.cpp:122-126) — a bug that silences stereo input by ~5
  orders of magnitude; ``reference_quirks=True`` reproduces it bit-for-bit
  (SURVEY.md §2a.13 says match behavior, don't copy bugs blindly — so the
  correct path is the default).

Feeding the device: these return pinned-host-friendly contiguous float32
numpy arrays; batching/padding to 480,000 samples happens in the engine.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

INT16_MAX = 32767.0
INT32_MAX = 2147483647.0


def _parse_riff_chunks(data: bytes):
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    chunks = {}
    off = 12
    while off + 8 <= len(data):
        cid = data[off : off + 4]
        (size,) = struct.unpack_from("<I", data, off + 4)
        chunks[cid] = (off + 8, size)
        off += 8 + size + (size & 1)  # chunks are word-aligned
    return chunks


def read_wav(
    path: str,
    expected_sample_rate: Optional[int] = 16_000,
    reference_quirks: bool = False,
) -> np.ndarray:
    """Read a WAV file → mono float32 in [-1, 1].

    Accepts PCM16 (format 1), PCM32, and IEEE float32 (format 3), mono or
    stereo. Raises on sample-rate mismatch when ``expected_sample_rate`` is
    set (the reference only fprintf-warns, wav_util.cpp:102-105, then
    produces garbage — failing fast is the useful behavior).
    """
    with open(path, "rb") as f:
        data = f.read()
    return read_wav_bytes(
        data, expected_sample_rate, reference_quirks, name=path
    )


def read_wav_bytes(
    data: bytes,
    expected_sample_rate: Optional[int] = 16_000,
    reference_quirks: bool = False,
    name: str = "<bytes>",
) -> np.ndarray:
    """In-memory variant of :func:`read_wav` (same contracts) — the decode
    path for network request bodies (engine/http_server.py)."""
    path = name
    chunks = _parse_riff_chunks(data)
    if b"fmt " not in chunks or b"data" not in chunks:
        raise ValueError(f"{path}: missing fmt/data chunk")

    fmt_off, _ = chunks[b"fmt "]
    audio_format, channels, sample_rate, _brate, _balign, bits = struct.unpack_from(
        "<HHIIHH", data, fmt_off
    )
    if expected_sample_rate and sample_rate != expected_sample_rate:
        raise ValueError(
            f"{path}: sample rate {sample_rate}, expected {expected_sample_rate}"
        )
    if channels not in (1, 2):
        raise ValueError(f"{path}: must be mono or stereo, got {channels} channels")

    d_off, d_size = chunks[b"data"]
    raw = data[d_off : d_off + d_size]

    if audio_format == 1 and bits == 16:
        samples = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        if channels == 2:
            pairs = samples[: 2 * (len(samples) // 2)].reshape(-1, 2)
            sums = pairs[:, 0] + pairs[:, 1]
            if reference_quirks:
                return (sums / INT32_MAX).astype(np.float32)  # wav_util.cpp:122-126
            return (sums / (2.0 * INT16_MAX)).astype(np.float32)
        return samples / np.float32(INT16_MAX)
    if audio_format == 1 and bits == 32:
        samples = np.frombuffer(raw, dtype="<i4").astype(np.float64) / INT32_MAX
    elif audio_format == 3 and bits == 32:
        samples = np.frombuffer(raw, dtype="<f4").astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported format={audio_format} bits={bits}")

    if channels == 2:
        pairs = samples[: 2 * (len(samples) // 2)].reshape(-1, 2)
        samples = pairs.mean(axis=1)
    return samples.astype(np.float32)


def read_wav_legacy(path: str) -> np.ndarray:
    """Fixed-44-byte-header reader matching wav_read_legacy
    (wav_util.cpp:18-87): no chunk walking; sample count =
    data_size / block_align; PCM16 → /32767; float32 passthrough."""
    with open(path, "rb") as f:
        header = f.read(44)
        if (
            header[:4] != b"RIFF"
            or header[8:12] != b"WAVE"
            or header[12:16] != b"fmt "
        ):
            raise ValueError(f"{path}: not a valid WAV file")
        audio_format, _ch, _sr, _br, block_align, _bits = struct.unpack_from(
            "<HHIIHH", header, 20
        )
        (wav_size,) = struct.unpack_from("<I", header, 40)
        num_samples = wav_size // block_align
        if audio_format == 1:
            raw = f.read(num_samples * 2)
            return (
                np.frombuffer(raw, dtype="<i2").astype(np.float32) / INT16_MAX
            )
        raw = f.read(num_samples * 4)
        return np.frombuffer(raw, dtype="<f4").astype(np.float32)


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16_000) -> None:
    """PCM16 mono WAV writer (the role of WaveUtil.java:14-50)."""
    samples = np.asarray(samples, dtype=np.float32)
    pcm = np.clip(samples * INT16_MAX, -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_pcm_f32(path: str) -> np.ndarray:
    """Raw float32 PCM file (the input format of app/vad.cpp and
    app/silent_detection.cpp)."""
    return np.fromfile(path, dtype="<f4")


def wav_to_pcm(wav_path: str, pcm_path: str) -> None:
    """Strip the WAV container, write raw sample bytes (app/wav_to_pcm.cpp:5-39
    — which blindly drops 44 bytes; we resolve the actual data chunk)."""
    with open(wav_path, "rb") as f:
        data = f.read()
    chunks = _parse_riff_chunks(data)
    d_off, d_size = chunks[b"data"]
    with open(pcm_path, "wb") as f:
        f.write(data[d_off : d_off + d_size])
