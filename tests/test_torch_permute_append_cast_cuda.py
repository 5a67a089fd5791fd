"""K2 and K2′ (permute_append, permute_append_sharded) converting the new
rows inside the kernel, against ``.to()`` and their plain versions, on the
card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_permute_append_cast_cuda.py

The kernel stores the new rows in the storage dtype itself. Its bytes must
equal PyTorch's ``.to()`` on the card BITWISE (compared as uint8): over all
65,536 bf16 and f16 patterns into every storage dtype, f32 values at the
edges of the fp8 formats (±0, ±inf, NaN, ±448, ±464, ±480, 2⁻¹⁰, 1.5·2⁻⁹,
−1e-9, the midpoints of adjacent fp8 values), strided rows, and K2′ on
global rows. The window moves bitwise as the plain version moves it, at
every pos of the flagship's 448-token context. Each call is one kernel launch,
counted with ``torch.profiler``; a dtype pair the kernel does not take
raises ``TypeError``.
"""

import pytest
import torch

from whisper_tpu_torch.ops import fused_step as tf

pytestmark = pytest.mark.cuda

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
STORAGE = [torch.float32, torch.bfloat16, torch.float16, E4M3, E5M2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _store(card, rows: torch.Tensor, storage: torch.dtype, pos: int = 1) -> torch.Tensor:
    """The bytes K2 stores at ``pos`` for new rows ``rows`` [BK, HD] (the
    same rows for K and V), one layer, parity 0."""
    bk, hd = rows.shape
    planes = [torch.zeros((2, 1, bk, pos + 1, hd), device=card).to(storage) for _ in range(2)]
    idx = torch.arange(bk, dtype=torch.int32, device=card)
    tf.permute_append(*planes, idx, 0, pos, 0, rows, rows)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(planes[0][1, 0, :, pos]), _bytes(planes[1][1, 0, :, pos]))
    return _bytes(planes[0][1, 0, :, pos])


@pytest.mark.parametrize("src", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16", "f16", "e4m3", "e5m2"])
def test_every_16_bit_pattern(card, src, storage):
    rows = torch.arange(-(2**15), 2**15, dtype=torch.int32, device=card).to(torch.int16)
    rows = rows.view(src).view(64, 1024)
    assert torch.equal(_store(card, rows, storage), _bytes(rows.to(storage)))


def _fp8_midpoints(dtype, card) -> torch.Tensor:
    """The midpoints of adjacent finite values of an fp8 format, both signs,
    in f32 (exact), and the f32 values one ulp either side of each."""
    vals = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype).float()
    vals = torch.unique(vals[torch.isfinite(vals)])  # sorted
    mid = (vals[1:] + vals[:-1]) / 2
    up, down = torch.nextafter(mid, mid + 1), torch.nextafter(mid, mid - 1)
    return torch.cat([mid, up, down]).to(card)


EDGES = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), -float("nan"),
         448.0, -448.0, 464.0, -464.0, 480.0, -480.0, 2.0**-10, 1.5 * 2.0**-9, -1e-9,
         57344.0, -57344.0, 61440.0, 65536.0, -65536.0, 2.0**-17, 1e-40, -1e-40, 3e38]


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16", "f16", "e4m3", "e5m2"])
def test_f32_edges(card, storage):
    vals = torch.cat([torch.tensor(EDGES, device=card), _fp8_midpoints(E4M3, card),
                      _fp8_midpoints(E5M2, card)])
    n = -(-vals.numel() // 64) * 64
    rows = torch.cat([vals, torch.zeros(n - vals.numel(), device=card)]).view(-1, 64)
    assert torch.equal(_store(card, rows, storage), _bytes(rows.to(storage)))


def _check_against_plain(card, shape, dtype, idx, pos, parity, kn, vn, call, plain):
    """``call`` on rows ``kn``, ``vn`` as given against ``plain`` on their
    contiguous copies: the window, the read plane and the other layers."""
    gen = torch.Generator(device=card).manual_seed(3)
    planes = [torch.randn(shape, generator=gen, device=card).mul(4).to(dtype) for _ in range(2)]
    ref = [p.clone() for p in planes]
    layer = shape[1] - 1
    call(*planes, idx, layer, pos, parity, kn, vn)
    plain(*ref, idx, layer, pos, parity, kn.contiguous(), vn.contiguous())
    torch.cuda.synchronize()
    w = 1 - parity
    for got, want in zip(planes, ref):
        assert torch.equal(_bytes(got[w, layer, :, : pos + 1]), _bytes(want[w, layer, :, : pos + 1]))
        assert torch.equal(_bytes(got[parity]), _bytes(want[parity]))
        assert torch.equal(_bytes(got[w, :layer]), _bytes(want[w, :layer]))


@pytest.mark.parametrize("kind", ["column slice", "transposed", "unaligned offset"])
@pytest.mark.parametrize("src, storage", [(torch.bfloat16, E4M3), (torch.float32, torch.bfloat16),
                                          (torch.float16, torch.float16)],
                         ids=["bf16-e4m3", "f32-bf16", "f16-f16"])
def test_strided_rows(card, kind, src, storage):
    bk, hd = 6, 384
    gen = torch.Generator(device=card).manual_seed(1)
    if kind == "column slice":
        wide = torch.randn((2, bk, 3 * hd), generator=gen, device=card).to(src)
        kn, vn = wide[0, :, 5 : 5 + hd], wide[1, :, hd + 1 : 2 * hd + 1]
    elif kind == "transposed":
        kn, vn = (torch.randn((hd, bk), generator=gen, device=card).to(src).t() for _ in range(2))
    else:  # a view one element past an aligned address
        flat = torch.randn(2 * bk * hd + 1, generator=gen, device=card).to(src)
        kn, vn = flat[1 : bk * hd + 1].view(bk, hd), flat[bk * hd + 1 :].view(bk, hd)
    assert not kn.is_contiguous() or kind == "unaligned offset"
    idx = torch.tensor([1, 1, 0, 5, 2, 2], dtype=torch.int32, device=card)
    for parity in (0, 1):
        _check_against_plain(card, (2, 3, bk, 24, hd), storage, idx, 17, parity, kn, vn,
                             tf.permute_append, tf.permute_append_reference)


@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("parity", [0, 1])
def test_sharded_global_rows(card, src, parity):
    beam, bk, hd = 5, 10, 1280
    gen = torch.Generator(device=card).manual_seed(2)
    slot = torch.randint(0, beam, (bk,), generator=gen, device=card)
    slot[1] = slot[0]
    idx = (bk + (torch.arange(bk, device=card) // beam) * beam + slot).to(torch.int32)  # rank 1 of 2
    kn, vn = (torch.randn((bk, hd), generator=gen, device=card).to(src) for _ in range(2))

    def call(*args):
        tf.permute_append_sharded(*args, beam=beam)

    def plain(*args):
        tf.permute_append_sharded_reference(*args, beam=beam)

    for pos in (0, 35, 67):
        _check_against_plain(card, (2, 4, bk, 68, hd), E4M3, idx, pos, parity, kn, vn, call, plain)


@pytest.mark.parametrize("pos", [0, 1, 35, 100, 255, 440, 447])
def test_windows_at_full_context(card, pos):
    bk, hd = 20, 1280
    gen = torch.Generator(device=card).manual_seed(pos)
    idx = torch.randint(0, bk, (bk,), generator=gen, device=card, dtype=torch.int32)
    idx[1] = idx[0]
    kn, vn = (torch.randn((bk, hd), generator=gen, device=card).to(torch.bfloat16) for _ in range(2))
    for parity in (0, 1):
        _check_against_plain(card, (2, 2, bk, 448, hd), E4M3, idx, pos, parity, kn, vn,
                             tf.permute_append, tf.permute_append_reference)


def _kernels_in(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32, E4M3], ids=["bf16", "f32", "e4m3"])
def test_one_kernel_per_call(card, src):
    bk, hd, beam = 10, 1280, 5
    planes = [torch.zeros((2, 2, bk, 68, hd), device=card).to(E4M3) for _ in range(2)]
    rows = torch.randn((bk, hd), device=card).to(src)
    idx = torch.arange(bk, dtype=torch.int32, device=card)
    tf.permute_append(*planes, idx, 1, 35, 0, rows, rows)  # warm: the library is loaded
    names = _kernels_in(lambda: tf.permute_append(*planes, idx, 1, 35, 0, rows, rows))
    assert len(names) == 1 and tf.KERNEL_SYMBOL in names[0], names
    names = _kernels_in(lambda: tf.permute_append_sharded(*planes, idx, 1, 35, 0, rows, rows, beam=beam))
    assert len(names) == 1 and tf.SHARDED_KERNEL_SYMBOL in names[0], names


def test_unsupported_pairs_raise(card):
    planes = [torch.zeros((2, 1, 4, 8, 64), device=card).to(E4M3) for _ in range(2)]
    idx = torch.arange(4, dtype=torch.int32, device=card)
    rows = torch.zeros((4, 64), device=card)
    before = tf.launches
    for k, v in ((rows.double(), rows.double()), (rows.to(E5M2), rows.to(E5M2)),
                 (rows.int(), rows.int()), (rows, rows.bfloat16())):
        with pytest.raises(TypeError):
            tf.permute_append(*planes, idx, 0, 1, 0, k, v)
    f32_planes = [torch.zeros((2, 1, 4, 8, 64), device=card) for _ in range(2)]
    with pytest.raises(TypeError):  # fp8 rows are copied raw into fp8 planes only
        tf.permute_append(*f32_planes, idx, 0, 1, 0, rows.to(E4M3), rows.to(E4M3))
    assert tf.launches == before
