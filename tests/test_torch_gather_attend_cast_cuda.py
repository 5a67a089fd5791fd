"""K3 (gather_attend) converting the new rows inside its kernel, against K2
and its plain version, on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gather_attend_cast_cuda.py

K3 stores the new rows in the storage dtype itself, as K2 does
(``csrc/store_cast.cuh``). For every pair of ``CAST_PAIRS`` into the planes
K3 reads, over the positions of a 448-token context (every position for
the flagship's pair, bf16 rows into fp8; positions on both sides of each
dtype's switch from registers to shared memory for the others), with
strided and unaligned rows: the write plane's window [0, pos], the read
plane and the other layers BITWISE equal (uint8) to K2's and to the plain
version's; ``attn`` within 4 bf16 ulps at max|ref| (bf16 query) or
1e-5 · max(1, max|ref|) (f32), as tests/test_torch_gather_attend_cuda.py.
Each call is one kernel, counted with ``torch.profiler``.
"""

import math

import pytest
import torch

from whisper_tpu_torch.ops import fused_step as tf
from whisper_tpu_torch.ops import gather_attend as ga

pytestmark = pytest.mark.cuda

E4M3 = torch.float8_e4m3fn
PAIRS = sorted(((r, s) for r, s in tf.CAST_PAIRS if s in ga.STORAGE_DTYPES), key=str)
N_HEAD, HD, BK, CTX = 2, 128, 6, 448  # Dh 64, as every Whisper model
# Positions either side of the switch to shared memory (4 passes of 128 /
# (Dh bytes / 16) positions: f32 32, bf16 64, fp8 128) and the ends.
POSITIONS = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 440, 447)


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


def _check(card, storage, kn, vn, positions, seed=0, shape=(2, 2, BK, CTX, HD), n_head=N_HEAD):
    """K3 with rows ``kn``, ``vn`` as given against the plain version and
    K2 on their contiguous copies, at each pos, both parities."""
    gen = torch.Generator(device=card).manual_seed(seed)
    bk, hd = shape[2], shape[4]
    q_dt = torch.float32 if storage == torch.float32 else torch.bfloat16
    idx = torch.randint(0, bk, (bk,), generator=gen, device=card, dtype=torch.int32)
    idx[1] = idx[0]  # a duplicate, always
    planes = [torch.randn(shape, generator=gen, device=card).mul(4).to(storage) for _ in range(2)]
    q = torch.randn((bk, hd), generator=gen, device=card).to(q_dt)
    layer = shape[1] - 1
    for pos in positions:
        for parity in (0, 1):
            ck, cv = (p.clone() for p in planes)
            rk, rv = (p.clone() for p in planes)
            k2k, k2v = (p.clone() for p in planes)
            before = ga.launches
            out, _, _ = ga.fused_gather_attend(ck, cv, idx, layer, pos, parity, q, kn, vn, n_head=n_head)
            ref, _, _ = ga.fused_gather_attend_reference(
                rk, rv, idx, layer, pos, parity, q, kn.contiguous(), vn.contiguous(), n_head=n_head)
            tf.permute_append(k2k, k2v, idx, layer, pos, parity, kn, vn)
            torch.cuda.synchronize()
            assert ga.launches == before + 1
            w = 1 - parity
            for got, plain, k2 in ((ck, rk, k2k), (cv, rv, k2v)):
                window = _bytes(got[w, layer, :, : pos + 1])
                assert torch.equal(window, _bytes(plain[w, layer, :, : pos + 1])), (pos, parity)
                assert torch.equal(window, _bytes(k2[w, layer, :, : pos + 1])), (pos, parity)
                assert torch.equal(_bytes(got[parity]), _bytes(plain[parity]))
                assert torch.equal(_bytes(got[w, :layer]), _bytes(plain[w, :layer]))
            assert out.dtype == q_dt and torch.isfinite(out.float()).all()
            assert (out.float() - ref.float()).abs().max().item() <= _tolerance(ref), (pos, parity)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{str(p[0])[6:]}->{str(p[1])[6:]}")
def test_every_pair(card, pair):
    rows_dt, storage = pair
    gen = torch.Generator(device=card).manual_seed(1)
    kn, vn = (torch.randn((BK, HD), generator=gen, device=card).to(rows_dt) for _ in range(2))
    _check(card, storage, kn, vn, POSITIONS)


def test_every_position_of_the_flagship_pair(card):
    gen = torch.Generator(device=card).manual_seed(2)
    kn, vn = (torch.randn((BK, HD), generator=gen, device=card).to(torch.bfloat16) for _ in range(2))
    _check(card, E4M3, kn, vn, range(CTX), seed=3, shape=(2, 1, BK, CTX, HD))


@pytest.mark.parametrize("kind", ["column slice", "transposed", "unaligned offset"])
@pytest.mark.parametrize("src, storage", [(torch.bfloat16, E4M3), (torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.bfloat16)],
                         ids=["bf16-e4m3", "f32-bf16", "bf16-bf16"])
def test_strided_and_unaligned_rows(card, kind, src, storage):
    gen = torch.Generator(device=card).manual_seed(4)
    if kind == "column slice":
        wide = torch.randn((2, BK, 3 * HD), generator=gen, device=card).to(src)
        kn, vn = wide[0, :, 5 : 5 + HD], wide[1, :, HD + 1 : 2 * HD + 1]
    elif kind == "transposed":
        kn, vn = (torch.randn((HD, BK), generator=gen, device=card).to(src).t() for _ in range(2))
    else:  # a view one element past an aligned address
        flat = torch.randn(2 * BK * HD + 1, generator=gen, device=card).to(src)
        kn, vn = flat[1 : BK * HD + 1].view(BK, HD), flat[BK * HD + 1 :].view(BK, HD)
    assert not kn.is_contiguous() or kn.data_ptr() % 16
    _check(card, storage, kn, vn, (0, 17, 100, 447), seed=5)


def _kernels_in(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32, E4M3], ids=["bf16", "f32", "e4m3"])
@pytest.mark.parametrize("pos", [35, 440], ids=["registers", "shared memory"])
def test_one_kernel_per_call(card, src, pos):
    bk, hd = 20, 1280  # large-v3 beam 5 batch 4
    planes = [torch.zeros((2, 2, bk, CTX, hd), device=card).to(E4M3) for _ in range(2)]
    rows = torch.randn((bk, hd), device=card).to(src)
    q = torch.randn((bk, hd), device=card).to(torch.bfloat16)
    idx = torch.arange(bk, dtype=torch.int32, device=card)

    def call():
        ga.fused_gather_attend(*planes, idx, 1, pos, 0, q, rows, rows, n_head=20)

    call()  # warm: the library is loaded
    names = _kernels_in(call)
    assert len(names) == 1 and ga.KERNEL_SYMBOL in names[0], names


def test_unsupported_pairs_raise(card):
    planes = [torch.zeros((2, 1, 4, 8, 64), device=card).to(E4M3) for _ in range(2)]
    idx = torch.arange(4, dtype=torch.int32, device=card)
    rows = torch.zeros((4, 64), device=card)
    q = rows.bfloat16()
    before = ga.launches
    for k, v in ((rows.double(), rows.double()), (rows.to(torch.float8_e5m2), rows.to(torch.float8_e5m2)),
                 (rows.int(), rows.int()), (rows, rows.bfloat16())):
        with pytest.raises(TypeError):
            ga.fused_gather_attend(*planes, idx, 0, 1, 0, q, k, v, n_head=2)
    f32_planes = [torch.zeros((2, 1, 4, 8, 64), device=card) for _ in range(2)]
    with pytest.raises(TypeError):  # fp8 rows are copied raw into fp8 planes only
        ga.fused_gather_attend(*f32_planes, idx, 0, 1, 0, rows, rows.to(E4M3), rows.to(E4M3), n_head=2)
    f16_planes = [p.half() for p in f32_planes]
    with pytest.raises(TypeError):  # f16 planes: a storage dtype K3 does not read
        ga.fused_gather_attend(*f16_planes, idx, 0, 1, 0, q, rows, rows, n_head=2)
    assert ga.launches == before
