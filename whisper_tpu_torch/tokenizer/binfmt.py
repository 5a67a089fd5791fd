"""Reader/writer for the reference's packed vocab+filters ``.bin`` asset.

Layout (documented at whisper.h:214-235; produced by app/writeout.cpp:43-59):

    [uint64 total_size]      -- OPTIONAL prefix: written by writeout.cpp and
                                skipped by the C++ engines (whisper.cpp:676-680)
                                but ABSENT in the layout the Java reader expects
                                (WhisperUtil.java:79-85). The two in-repo readers
                                disagree, so we auto-detect (SURVEY.md §2a.12).
    uint32 magic             -- C++ ignores the value (whisper.cpp:522-528);
                                Java requires 0x5553454e ("USEN"). We accept any
                                but record it.
    int32  n_mel, int32 n_fft_bins
    float32[n_mel * n_fft_bins]  mel filterbank (row-major [n_mel][n_fft_bins])
    int32  n_vocab
    n_vocab × { uint32 len; uint8 bytes[len] }

All integers little-endian.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from whisper_tpu_torch.tokenizer.vocab import Vocab

MAGIC_USEN = 0x5553454E


@dataclasses.dataclass
class BinAssets:
    mel_filters: np.ndarray  # [n_mel, n_fft_bins] float32
    vocab: Vocab
    magic: int
    had_size_prefix: bool


def _looks_like_filter_header(buf: memoryview, off: int) -> bool:
    """Heuristic: after a uint32 magic we expect plausible n_mel (80/128) and
    n_fft_bins (201/256-ish) int32s."""
    if off + 12 > len(buf):
        return False
    n_mel, n_fft = struct.unpack_from("<ii", buf, off + 4)
    return 0 < n_mel <= 512 and 0 < n_fft <= 4096


def read_bin(path_or_bytes, multilingual: bool) -> BinAssets:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = memoryview(bytes(path_or_bytes))
    else:
        # Whole-file read; the reference mmaps (mmap_file.cpp:13-66) because it
        # re-reads lazily — we parse once into arrays, so a read() is simpler
        # and the OS page cache serves the same purpose.
        with open(path_or_bytes, "rb") as f:
            data = memoryview(f.read())

    off = 0
    had_prefix = False
    # Auto-detect the uint64 size prefix: if bytes [8:20) parse as a sane
    # filter header and bytes [0:12) do not, the prefix is present.
    if len(data) >= 20:
        direct_ok = _looks_like_filter_header(data, 0)
        prefixed_ok = _looks_like_filter_header(data, 8)
        if prefixed_ok and not direct_ok:
            (total,) = struct.unpack_from("<Q", data, 0)
            off = 8
            had_prefix = True
        elif prefixed_ok and direct_ok:
            # Ambiguous; trust the size prefix if it matches remaining length.
            (total,) = struct.unpack_from("<Q", data, 0)
            if total == len(data) - 8 or total == len(data):
                off = 8
                had_prefix = True

    (magic,) = struct.unpack_from("<I", data, off)
    off += 4
    n_mel, n_fft = struct.unpack_from("<ii", data, off)
    off += 8
    count = n_mel * n_fft
    filters = np.frombuffer(data, dtype="<f4", count=count, offset=off).reshape(
        n_mel, n_fft
    )
    off += 4 * count

    (n_vocab,) = struct.unpack_from("<i", data, off)
    off += 4
    table: Dict[int, bytes] = {}
    for i in range(n_vocab):
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        table[i] = bytes(data[off : off + ln])
        off += ln

    vocab = Vocab(table, multilingual=multilingual, n_vocab=n_vocab)
    return BinAssets(
        mel_filters=np.ascontiguousarray(filters, dtype=np.float32),
        vocab=vocab,
        magic=magic,
        had_size_prefix=had_prefix,
    )


def write_bin(
    path: str,
    mel_filters: np.ndarray,
    id_to_token: Dict[int, bytes],
    magic: int = MAGIC_USEN,
    size_prefix: bool = True,
) -> None:
    """Asset packager (the role of app/writeout.cpp:10-67, minus the embedded
    C arrays). Emits the uint64 size prefix by default to match writeout's
    output; pass ``size_prefix=False`` for the Java-reader layout."""
    mel_filters = np.asarray(mel_filters, dtype="<f4")
    n_mel, n_fft = mel_filters.shape
    body = bytearray()
    body += struct.pack("<I", magic)
    body += struct.pack("<ii", n_mel, n_fft)
    body += mel_filters.tobytes()
    n_vocab = len(id_to_token)
    body += struct.pack("<i", n_vocab)
    for i in range(n_vocab):
        tok = id_to_token[i]
        body += struct.pack("<I", len(tok))
        body += tok
    with open(path, "wb") as f:
        if size_prefix:
            f.write(struct.pack("<Q", len(body)))
        f.write(bytes(body))
