"""whisper_tpu_torch.frontend.mel_fused (K5's plain version) against
whisper_tpu.frontend.mel_pallas.log_mel_spectrogram_fused.

Both sides run float32 on the CPU; JAX's Pallas kernel runs in interpret
mode (seconds per call), once per input, shared through module fixtures.
Outputs are held to 2e-4 in log-mel units, JAX's own tolerance for its
fused kernel against its matmul path (tests/test_mel.py): the DFT and mel
products sum in another order. The kernel's constants (windowed-DFT basis,
fold-prescaled filterbank) are bitwise equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.frontend.mel_pallas import _basis as jax_basis
from whisper_tpu.frontend.mel_pallas import log_mel_spectrogram_fused as jax_fused
from whisper_tpu_torch.frontend import mel_fused
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram

torch.set_num_threads(2)

N = 480_000
TOL = 2e-4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "batch2_80": ((rng.normal(size=(2, N)) * 0.1).astype(np.float32), 80),
        "single_128": ((rng.normal(size=(N,)) * 0.1).astype(np.float32), 128),
    }


@pytest.fixture(scope="module")
def jax_out(inputs):
    return {k: np.asarray(jax_fused(jnp.asarray(x), n_mels=m, interpret=True)) for k, (x, m) in inputs.items()}


@pytest.mark.parametrize("case", ["batch2_80", "single_128"])
def test_plain_version_equals_jax(inputs, jax_out, case):
    x, n_mels = inputs[case]
    before = mel_fused.launches
    ours = mel_fused.log_mel_spectrogram_fused(torch.from_numpy(x), n_mels=n_mels)
    assert mel_fused.launches == before  # the CPU takes the plain version
    assert ours.shape == jax_out[case].shape == (*x.shape[:-1], n_mels, 3000)
    np.testing.assert_allclose(ours.numpy(), jax_out[case], rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["batch2_80", "single_128"])
def test_plain_version_equals_matmul_path(inputs, case):
    x, n_mels = inputs[case]
    ours = mel_fused.log_mel_spectrogram_fused_reference(torch.from_numpy(x), n_mels=n_mels)
    ref = log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_constants_equal_jax(n_mels):
    blocks, filt_p = jax_basis(n_mels)
    w_jax = np.concatenate([blocks[0], blocks[1], blocks[2, :80]])  # [400, 512]
    w, filt = mel_fused._basis(n_mels)
    nb, pad = mel_fused.N_BINS, mel_fused.BIN_PAD
    np.testing.assert_array_equal(w[:, :nb], w_jax[:, :nb])
    np.testing.assert_array_equal(w[:, pad : pad + nb], w_jax[:, 256 : 256 + nb])
    assert not w[:, nb:pad].any() and not w[:, pad + nb :].any()
    np.testing.assert_array_equal(filt[:, :n_mels], filt_p[:nb, :n_mels])
    assert not filt[:, n_mels:].any()


def test_rejects_wrong_length_and_too_many_mels():
    with pytest.raises(ValueError):
        mel_fused.log_mel_spectrogram_fused(torch.zeros(2, 16_000))
    with pytest.raises(ValueError):
        mel_fused.log_mel_spectrogram_fused(torch.zeros(N), n_mels=129)
