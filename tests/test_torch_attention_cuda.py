"""K1's CUDA kernel against its plain version, on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_cuda.py

Tolerances: bfloat16 4 ulps at the output's largest magnitude (kernel and
plain version round the softmax weights and the output at different
places); float32 atol 1e-5. Every case also checks that the wrapper
launched the kernel once.
"""

import math

import pytest
import torch

from whisper_tpu_torch.ops import attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    return torch.device("cuda", 0)


def _tolerance(ref: torch.Tensor) -> float:
    ref_max = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return 4.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-20))) - 7)
    return 1e-5 * max(1.0, ref_max)


@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((4, 1500, 20, 64), torch.bfloat16),
        ((2, 100, 6, 64), torch.bfloat16),
        ((2, 1, 2, 64), torch.bfloat16),
        ((2, 1500, 2, 32), torch.bfloat16),
        ((2, 1500, 6, 64), torch.float32),
        ((3, 77, 3, 32), torch.float32),
    ],
)
def test_kernel_matches_plain_version(card, shape, dtype):
    _check_case(card, shape, dtype)


# The encoder's audio_ctx buckets (256, 512, 1024) and full window (1500) at
# large-v3's 20 heads, where T is a multiple of the 128-key tile (no mask)
# or not (1500: 92 keys in the last tile; 1499; 100: one ragged tile; 1: one
# key, one query); and Dh = 32 (the dev dims) at one tile and at 1500.
@pytest.mark.parametrize(
    "shape",
    [(2, t, 20, 64) for t in (1, 100, 256, 512, 1024, 1499, 1500)]
    + [(2, 64, 4, 32), (2, 1500, 4, 32)],
)
def test_bf16_kernel_across_lengths(card, shape):
    _check_case(card, shape, torch.bfloat16)


def _check_case(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
    before = ta.launches
    out = ta.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    ref = ta.fused_self_attention_reference(q, k, v)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert (out.float() - ref.float()).abs().max().item() <= _tolerance(ref)


@pytest.mark.parametrize("dh", [64, 32])
def test_strided_inputs(card, dh):
    # q, k, v as views of one fused [B, T, 3, H, Dh] projection.
    x = torch.randn(2, 300, 3, 4, dh, device=card).to(torch.bfloat16)
    q, k, v = x.unbind(2)
    before = ta.launches
    out = ta.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    ref = ta.fused_self_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= _tolerance(ref)
