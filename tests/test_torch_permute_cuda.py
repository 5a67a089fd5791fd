"""K2 (permute_append) and K4 (permute_rows) CUDA kernels against their
plain versions, on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_permute_cuda.py

Both kernels move bytes, so the kernel and the plain version must agree
BITWISE (compared as uint8) over what each defines: for K2 the window
[0, pos] of the write plane, the read plane and the other layers; for K4
the whole output.
"""

import pytest
import torch

from whisper_tpu_torch.ops import fused_step as tf
from whisper_tpu_torch.ops import gather as tg

pytestmark = pytest.mark.cuda

FP8 = torch.float8_e4m3fn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _rand(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).mul(4).to(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((2, 32, 20, 68, 1280), FP8),  # large-v3 beam 5 batch 4
        ((2, 32, 20, 68, 1280), torch.bfloat16),
        ((2, 4, 6, 40, 384), torch.float32),  # tiny beam 3 batch 2
        ((2, 2, 6, 17, 64), FP8),  # dev: a 64-byte position
    ],
)
@pytest.mark.parametrize("parity", [0, 1])
def test_permute_append_matches_plain(card, shape, dtype, parity):
    gen = torch.Generator(device=card).manual_seed(0)
    _, n_layer, bk, ctx, hd = shape
    idx = torch.randint(0, bk, (bk,), generator=gen, device=card, dtype=torch.int32)
    idx[0] = idx[1]  # a duplicate, always
    layer = n_layer - 1
    for pos in (0, 4, ctx // 2, ctx - 1):
        ck, cv = _rand(shape, dtype, gen, card), _rand(shape, dtype, gen, card)
        kn, vn = _rand((bk, hd), torch.float32, gen, card), _rand((bk, hd), torch.float32, gen, card)
        ref_k, ref_v = ck.cpu(), cv.cpu()
        tf.permute_append_reference(ref_k, ref_v, idx.cpu(), layer, pos, parity, kn.cpu(), vn.cpu())
        before = tf.launches
        tf.permute_append(ck, cv, idx, layer, pos, parity, kn, vn)
        torch.cuda.synchronize()
        assert tf.launches == before + 1
        for got, ref in ((ck.cpu(), ref_k), (cv.cpu(), ref_v)):
            w = 1 - parity
            assert torch.equal(_bytes(got[w, layer, :, : pos + 1]), _bytes(ref[w, layer, :, : pos + 1]))
            assert torch.equal(_bytes(got[parity]), _bytes(ref[parity]))
            assert torch.equal(_bytes(got[w, :layer]), _bytes(ref[w, :layer]))


@pytest.mark.parametrize(
    "shape, dtype, limit",
    [
        ((32, 20, 68, 20, 64), FP8, 36),  # large-v3 beam 5 batch 4, window
        ((32, 20, 68, 20, 64), torch.bfloat16, 68),
        ((4, 6, 40, 6, 64), torch.float32, 11),
        ((2, 6, 17, 2, 32), FP8, 5),  # dev: a 64-byte position
    ],
)
def test_permute_rows_matches_plain(card, shape, dtype, limit):
    gen = torch.Generator(device=card).manual_seed(1)
    n = shape[1]
    idx = torch.randint(0, n, (n,), generator=gen, device=card, dtype=torch.int32)
    idx[-1] = idx[0]
    x = _rand(shape, dtype, gen, card)
    out = torch.zeros_like(x)
    before = tg.launches
    tg.permute_rows(x[:, :, :limit], idx, out=out[:, :, :limit])
    full = tg.permute_rows(x, idx)
    torch.cuda.synchronize()
    assert tg.launches == before + 2
    ref = tg.permute_rows_reference(x.cpu(), idx.cpu())
    assert torch.equal(_bytes(full.cpu()), _bytes(ref))
    assert torch.equal(_bytes(out[:, :, :limit].cpu()), _bytes(ref[:, :, :limit]))
    assert torch.equal(_bytes(out[:, :, limit:].cpu()), torch.zeros_like(_bytes(ref[:, :, limit:])))


def test_refusals(card):
    planes = torch.zeros(2, 1, 2, 4, 3, device=card)  # 12-byte positions
    idx = torch.zeros(2, dtype=torch.int32, device=card)
    new = torch.zeros(2, 3, device=card)
    with pytest.raises(ValueError):
        tf.permute_append(planes, planes.clone(), idx, 0, 1, 0, new, new)
    planes = torch.zeros(2, 1, 2, 4, 8, device=card)
    f64 = torch.zeros(2, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):  # new rows in a dtype the kernel does not convert
        tf.permute_append(planes, planes.clone(), idx, 0, 1, 0, f64, f64)
    x = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(TypeError):
        tg.permute_rows(x, idx.long())
    with pytest.raises(ValueError):
        tg.permute_rows(x, idx, out=x)  # in place
