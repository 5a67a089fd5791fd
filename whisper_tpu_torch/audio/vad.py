"""Energy VAD and silence stripping — vectorized batch pre-filters.

The port's own copy of ``whisper_tpu/audio/vad.py`` (numpy only): an
RMS-energy speech/silence classifier (threshold 0.01 over 512-sample
frames), dB-threshold silence removal at -35 dB, and the speech spans that
cut long audio into 30 s-max utterances. ``engine/serving.StreamingSession``
flushes at the silences :func:`energy_vad` finds.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FRAME_SIZE = 512  # app/vad.cpp FRAME_SIZE / silent_detection buffer_size
VAD_THRESHOLD = 0.01  # app/vad.cpp VAD_THRESHOLD
SILENCE_DB = -35.0  # app/silent_detection.cpp silence_threshold_db


def frame_energies(samples: np.ndarray, frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Per-frame RMS energy ``sqrt(mean(x^2))`` over non-overlapping frames.
    Trailing partial frames are dropped, matching the reference's
    full-buffer-only fread loop (vad.cpp:25)."""
    samples = np.asarray(samples, dtype=np.float32)
    n_frames = len(samples) // frame_size
    if n_frames == 0:
        return np.zeros((0,), dtype=np.float32)
    frames = samples[: n_frames * frame_size].reshape(n_frames, frame_size)
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1)).astype(np.float32)


def energy_vad(
    samples: np.ndarray,
    threshold: float = VAD_THRESHOLD,
    frame_size: int = FRAME_SIZE,
) -> np.ndarray:
    """Boolean speech mask per frame (vad.cpp:37-41: energy > threshold)."""
    return frame_energies(samples, frame_size) > threshold


def remove_silence(
    samples: np.ndarray,
    threshold_db: float = SILENCE_DB,
    frame_size: int = FRAME_SIZE,
) -> np.ndarray:
    """Drop frames quieter than ``threshold_db`` (silent_detection.cpp:49-62:
    dB = 20*log10(rms), keep frames >= threshold). Keeps whole frames — the
    reference writes only a quarter of each kept frame due to a bytes-vs-
    -floats confusion (pcm_file.write(..., buffer_size)), which we do not
    reproduce."""
    energies = frame_energies(samples, frame_size)
    with np.errstate(divide="ignore"):
        db = 20.0 * np.log10(energies)
    keep = db >= threshold_db
    n_frames = len(energies)
    frames = samples[: n_frames * frame_size].reshape(n_frames, frame_size)
    return frames[keep].reshape(-1).astype(np.float32, copy=False)


def speech_segments(
    samples: np.ndarray,
    threshold: float = VAD_THRESHOLD,
    frame_size: int = FRAME_SIZE,
    min_silence_frames: int = 16,  # ~0.5 s of 32 ms frames
    min_speech_frames: int = 2,
) -> List[Tuple[int, int]]:
    """Contiguous speech spans as (start_sample, end_sample) pairs.

    This is the segmentation layer the reference leaves to its Android mic
    queue (Whisper.java:130-174); here it drives how long audio is cut into
    30 s-max utterances that fan out as data-parallel batch items.
    """
    mask = energy_vad(samples, threshold, frame_size)
    segments: List[Tuple[int, int]] = []
    start = None
    silence_run = 0
    for i, speech in enumerate(mask):
        if speech:
            if start is None:
                start = i
            silence_run = 0
        elif start is not None:
            silence_run += 1
            if silence_run >= min_silence_frames:
                end = i - silence_run + 1
                if end - start >= min_speech_frames:
                    segments.append((start * frame_size, end * frame_size))
                start, silence_run = None, 0
    if start is not None:
        end = len(mask)
        while end > start and not mask[end - 1]:
            end -= 1
        if end - start >= min_speech_frames:
            segments.append((start * frame_size, end * frame_size))
    return segments
