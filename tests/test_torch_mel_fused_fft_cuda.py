"""K5 (log_mel_fused) CUDA kernel, the factorised real DFT, against its plain
version on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mel_fused_fft_cuda.py

Tolerance: 2e-4 in log-mel units, K5's contract (JAX's for its fused
kernel against its matmul path, tests/test_mel.py): the kernel's 20 × 20
DFT sums in another order than the plain version's dense f32 matmuls
(TF32 off). Inputs: a tone with noise followed by silence (quiet bins, the
floor at max − 8), all zeros, 80 and 128 mels, batches of 1, 3, 4 and 8.
Each utterance of a batch must equal the same utterance alone BITWISE: the
kernel computes every frame alone, whatever its batch or block.
"""

import pytest
import torch

from whisper_tpu_torch.frontend import mel_fused

pytestmark = pytest.mark.cuda

N = 480_000
TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmuls in full f32
    return torch.device("cuda", 0)


def _tone_then_silence(card, batch: int) -> torch.Tensor:
    """Row r: a tone of 200 + 150 r Hz with noise for 4 + 3 r seconds,
    then silence."""
    gen = torch.Generator(device=card).manual_seed(batch)
    t = torch.arange(N, device=card) / 16_000.0
    x = torch.zeros((batch, N), device=card)
    for r in range(batch):
        n = min(N, int(16_000 * (4 + 3 * r)))
        tone = 0.3 * torch.sin(2 * torch.pi * (200.0 + 150.0 * r) * t[:n])
        x[r, :n] = tone + 0.01 * torch.randn(n, generator=gen, device=card)
    return x


@pytest.mark.parametrize("batch", [1, 3, 4, 8])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_matches_plain(card, batch, n_mels):
    x = _tone_then_silence(card, batch)
    before = mel_fused.launches
    out = mel_fused.log_mel_spectrogram_fused(x, n_mels=n_mels)
    torch.cuda.synchronize()
    assert mel_fused.launches == before + 1  # one launch per batch
    assert out.shape == (batch, n_mels, 3000) and torch.isfinite(out).all()
    ref = mel_fused.log_mel_spectrogram_fused_reference(x, n_mels=n_mels)
    assert (out - ref).abs().max().item() <= TOL
    for r in range(batch):  # each utterance alone: its row of the batch, bitwise
        alone = mel_fused.log10_mel_kernel(x[r : r + 1].contiguous(), n_mels)
        assert torch.equal(alone[0], mel_fused.log10_mel_kernel(x, n_mels)[r])


@pytest.mark.parametrize("n_mels", [80, 128])
def test_all_zero_input(card, n_mels):
    x = torch.zeros((3, N), device=card)
    out = mel_fused.log_mel_spectrogram_fused(x, n_mels=n_mels)
    ref = mel_fused.log_mel_spectrogram_fused_reference(x, n_mels=n_mels)
    assert torch.equal(out, ref)
    assert (out == out[0, 0, 0]).all()


def test_unaligned_samples(card):
    flat = _tone_then_silence(card, 2).flatten()
    x = torch.cat([torch.zeros(1, device=card), flat])[1:].view(2, N)  # 4 bytes past an aligned address
    assert x.data_ptr() % 16
    with pytest.raises(ValueError):  # the kernel alone takes 16-byte aligned samples
        mel_fused.log10_mel_kernel(x, 80)
    out = mel_fused.log_mel_spectrogram_fused(x, n_mels=80)  # the entry point copies them
    assert torch.equal(out, mel_fused.log_mel_spectrogram_fused(x.clone(), n_mels=80))
