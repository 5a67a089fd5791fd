"""whisper_tpu_torch.frontend against whisper_tpu.frontend.

Both sides run float32 on the CPU. The filterbank is a numpy copy and is
bit-equal. The log-mel output is compared with atol 1e-4: the windowed-DFT
and filterbank products sum in another order, which moves the log10 by a few
f32 ulps of the power; 1e-4 on features of order 1 leaves room for that and
still catches a framing or fold error (either moves values by > 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.frontend.filters import mel_filterbank as jax_filterbank
from whisper_tpu.frontend.mel import log_mel_spectrogram as jax_log_mel
from whisper_tpu.frontend.mel import pad_or_trim as jax_pad_or_trim
from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram, pad_or_trim

torch.set_num_threads(2)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_bit_equal(n_mels):
    ours, ref = mel_filterbank(n_mels=n_mels), jax_filterbank(n_mels=n_mels)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _tone_and_noise(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


CASES = {
    "full_30s": lambda: _tone_and_noise(30.0, 0)[None, :],
    "short_clip": lambda: np.stack([_tone_and_noise(1.3, 1), _tone_and_noise(1.3, 2)]),
    "silence": lambda: np.zeros((1, 480_000), np.float32),
}


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_log_mel_matches_jax(case, n_mels):
    x = CASES[case]()
    ref = np.asarray(jax_log_mel(jnp.asarray(x), n_mels=n_mels))
    ours = log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels)
    assert ours.shape == ref.shape == (x.shape[0], n_mels, x.shape[1] // 160)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_padded_window_matches_jax():
    # The engine's input: a 4 s clip zero-padded to the 30 s window.
    x = np.asarray(jax_pad_or_trim(jnp.asarray(_tone_and_noise(4.0, 3))))
    ours_padded = pad_or_trim(torch.from_numpy(_tone_and_noise(4.0, 3)))
    np.testing.assert_array_equal(ours_padded.numpy(), x)
    ref = np.asarray(jax_log_mel(jnp.asarray(x[None])))
    np.testing.assert_allclose(
        log_mel_spectrogram(ours_padded[None]).numpy(), ref, rtol=0, atol=1e-4
    )


def test_filters_argument_is_used():
    x = torch.from_numpy(_tone_and_noise(1.0, 4))[None]
    f = torch.from_numpy(mel_filterbank(n_mels=80))
    torch.testing.assert_close(log_mel_spectrogram(x, f), log_mel_spectrogram(x))
