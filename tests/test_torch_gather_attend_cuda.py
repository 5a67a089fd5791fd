"""K3 (gather_attend) CUDA kernel against its plain version, on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gather_attend_cuda.py

The planes move as bytes, so the write plane's window [0, pos], the read
plane and the other layers must be BITWISE equal (uint8). ``attn``: with a
bf16 query 4 bf16 ulps at max|ref| (the kernel and the plain version round
the weights to bf16 after exponentials that may differ in the last f32
bit, and sum in other orders); with an f32 query 1e-5 · max(1, max|ref|).
"""

import math

import pytest
import torch

from whisper_tpu_torch.ops import gather_attend as ga

pytestmark = pytest.mark.cuda

FP8 = torch.float8_e4m3fn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _tolerance(ref: torch.Tensor) -> float:
    ref_max = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return 4.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-20))) - 7)
    return 1e-5 * max(1.0, ref_max)


@pytest.mark.parametrize(
    "shape, n_head, dtype, q_dtype",
    [
        ((2, 32, 20, 68, 1280), 20, FP8, torch.bfloat16),  # large-v3 beam 5 batch 4
        ((2, 32, 20, 68, 1280), 20, torch.bfloat16, torch.bfloat16),
        ((2, 4, 6, 40, 384), 6, torch.float32, torch.float32),  # tiny beam 3 batch 2
        ((2, 2, 6, 17, 64), 2, FP8, torch.bfloat16),  # dev: Dh 32
        ((2, 3, 8, 32, 64), 4, FP8, torch.float32),  # Dh 16, an f32 query
    ],
)
@pytest.mark.parametrize("parity", [0, 1])
def test_kernel_matches_plain(card, shape, n_head, dtype, q_dtype, parity):
    gen = torch.Generator(device=card).manual_seed(0)
    _, n_layer, bk, ctx, hd = shape
    idx = torch.randint(0, bk, (bk,), generator=gen, device=card, dtype=torch.int32)
    idx[0] = idx[1]  # a duplicate, always
    layer = n_layer - 1
    for pos in (0, 4, ctx // 2, ctx - 1):
        ck, cv = ((4 * torch.randn(shape, generator=gen, device=card)).to(dtype) for _ in range(2))
        q = torch.randn((bk, hd), generator=gen, device=card).to(q_dtype)
        kn, vn = (torch.randn((bk, hd), generator=gen, device=card) for _ in range(2))
        rk, rv = ck.clone(), cv.clone()
        ref, _, _ = ga.fused_gather_attend_reference(rk, rv, idx, layer, pos, parity, q, kn, vn, n_head=n_head)
        before = ga.launches
        out, _, _ = ga.fused_gather_attend(ck, cv, idx, layer, pos, parity, q, kn, vn, n_head=n_head)
        torch.cuda.synchronize()
        assert ga.launches == before + 1
        w = 1 - parity
        for got, exp in ((ck, rk), (cv, rv)):
            assert torch.equal(_bytes(got[w, layer, :, : pos + 1]), _bytes(exp[w, layer, :, : pos + 1]))
            assert torch.equal(_bytes(got[parity]), _bytes(exp[parity]))
            assert torch.equal(_bytes(got[w, :layer]), _bytes(exp[w, :layer]))
        assert out.shape == ref.shape and out.dtype == ref.dtype == q_dtype
        assert torch.isfinite(out.float()).all()
        assert (out.float() - ref.float()).abs().max().item() <= _tolerance(ref)


def test_refusals(card):
    idx = torch.zeros(2, dtype=torch.int32, device=card)
    planes = torch.zeros(2, 1, 2, 4, 96, device=card, dtype=torch.bfloat16)  # 96-byte head slices
    x = torch.zeros(2, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ga.fused_gather_attend(planes, planes.clone(), idx, 0, 1, 0, x, x, x, n_head=2)
    planes = torch.zeros(2, 1, 2, 4, 64, device=card, dtype=torch.bfloat16)
    x = torch.zeros(2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # a float16 query
        ga.fused_gather_attend(planes, planes.clone(), idx, 0, 1, 0, x.half(), x, x, n_head=2)
    with pytest.raises(TypeError):  # int64 indices
        ga.fused_gather_attend(planes, planes.clone(), idx.long(), 0, 1, 0, x, x, x, n_head=2)
    with pytest.raises(TypeError):  # float16 planes
        ga.fused_gather_attend(planes.half(), planes.half(), idx, 0, 1, 0, x, x, x, n_head=2)
    with pytest.raises(TypeError):  # float64 rows: a pair outside CAST_PAIRS
        ga.fused_gather_attend(planes, planes.clone(), idx, 0, 1, 0, x, x.double(), x.double(), n_head=2)
