"""K5 (log_mel_fused) CUDA kernel against its plain version, on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mel_fused_cuda.py

Tolerance: 2e-4 in log-mel units, JAX's own for its fused kernel against
its matmul path (tests/test_mel.py): the kernel sums the DFT and the mel
products in f32 FMA in another order than the plain version's f32 matmuls
(TF32 off). Also against the engine's ``frontend/mel.log_mel_spectrogram``.
"""

import pytest
import torch

from whisper_tpu_torch.frontend import mel_fused
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram

pytestmark = pytest.mark.cuda

N = 480_000
TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' matmuls in full f32
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape, n_mels", [((4, N), 128), ((2, N), 80), ((N,), 128), ((1, 2, N), 80)])
def test_kernel_matches_plain(card, shape, n_mels):
    gen = torch.Generator(device=card).manual_seed(0)
    x = 0.1 * torch.randn(shape, generator=gen, device=card)
    x[..., 400_000:] = 0.0  # a zero-padded tail, as the engine's short utterances have
    before = mel_fused.launches
    out = mel_fused.log_mel_spectrogram_fused(x, n_mels=n_mels)
    torch.cuda.synchronize()
    assert mel_fused.launches == before + 1
    assert out.shape == (*shape[:-1], n_mels, 3000) and torch.isfinite(out).all()
    ref = mel_fused.log_mel_spectrogram_fused_reference(x, n_mels=n_mels)
    assert (out - ref).abs().max().item() <= TOL
    eng = log_mel_spectrogram(x, n_mels=n_mels)
    assert (out - eng).abs().max().item() <= TOL


def test_refusals(card):
    with pytest.raises(ValueError):
        mel_fused.log_mel_spectrogram_fused(torch.zeros(2, 16_000, device=card))
    with pytest.raises(ValueError):
        mel_fused.log_mel_spectrogram_fused(torch.zeros(N, device=card), n_mels=129)
    with pytest.raises(TypeError):
        mel_fused.log_mel_spectrogram_fused(torch.zeros(N, device=card, dtype=torch.int16))
