"""The port's copy of audio/vad.py against whisper_tpu's, on seeded signals.

Both are numpy, so every output must be EQUAL: frame energies, the speech
mask, the silence-stripped samples and the speech spans.
"""

import numpy as np
import pytest

from whisper_tpu.audio import vad as jvad
from whisper_tpu_torch import audio as taudio
from whisper_tpu_torch.audio import vad as tvad


def _signal(kind, seed):
    rng = np.random.default_rng(seed)
    sr = 16_000
    if kind == "noise":
        return (0.1 * rng.standard_normal(sr * 2)).astype(np.float32)
    if kind == "bursts":  # speech-like bursts between silences, a ragged tail
        x = np.zeros(sr * 6 + 300, np.float32)
        for start in (0.3, 1.9, 2.2, 4.5):
            a, n = int(start * sr), int(rng.uniform(0.1, 0.9) * sr)
            x[a : a + n] = 0.2 * rng.standard_normal(len(x[a : a + n]))
        return x
    if kind == "quiet":  # around the thresholds
        return (rng.uniform(0.005, 0.02) * rng.standard_normal(sr * 3)).astype(np.float32)
    if kind == "short":  # under one frame
        return rng.standard_normal(300).astype(np.float32)
    return np.zeros(sr, np.float32)


KINDS = ["noise", "bursts", "quiet", "short", "silence"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_vad_equal_to_jax(kind, seed):
    x = _signal(kind, seed)
    np.testing.assert_array_equal(tvad.frame_energies(x), jvad.frame_energies(x))
    np.testing.assert_array_equal(tvad.energy_vad(x), jvad.energy_vad(x))
    np.testing.assert_array_equal(tvad.energy_vad(x, 0.05, 256), jvad.energy_vad(x, 0.05, 256))
    np.testing.assert_array_equal(tvad.remove_silence(x), jvad.remove_silence(x))
    np.testing.assert_array_equal(tvad.remove_silence(x, -20.0), jvad.remove_silence(x, -20.0))
    assert tvad.speech_segments(x) == jvad.speech_segments(x)
    assert tvad.speech_segments(x, min_silence_frames=4, min_speech_frames=1) == jvad.speech_segments(
        x, min_silence_frames=4, min_speech_frames=1
    )


def test_bursts_split_into_spans():
    spans = tvad.speech_segments(_signal("bursts", 0), min_silence_frames=8)
    assert len(spans) >= 3
    assert all(a < b for a, b in spans)


def test_exports():
    for name in ("frame_energies", "energy_vad", "remove_silence", "speech_segments"):
        assert getattr(taudio, name) is getattr(tvad, name)
        assert name in taudio.__all__
    assert (tvad.FRAME_SIZE, tvad.VAD_THRESHOLD, tvad.SILENCE_DB) == (
        jvad.FRAME_SIZE, jvad.VAD_THRESHOLD, jvad.SILENCE_DB
    )
