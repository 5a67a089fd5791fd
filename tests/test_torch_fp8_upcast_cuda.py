"""K6 (fp8_upcast) against its plain version on the card, and the card's
divides that mirror a JAX divide held to the host's.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fp8_upcast_cuda.py

Every fp8 value is exact in bf16, so the kernel and ``.to(torch.bfloat16)``
must agree BITWISE (NaN codes NaN). PyTorch's CUDA divide by a host scalar
multiplies by the scalar's reciprocal; the port's divides that mirror a JAX
divide (``models/quantize.absmax_quantize``, ``decode/beam.length_norm``,
the head average of ``decode/align.alignment_matrix``) take a divisor on
the device, so on values where ``a * (1/d) != a / d`` in f32 the card must
still equal the host and numpy's divide bitwise.
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode import align, beam
from whisper_tpu_torch.models.params import init_params, to_device
from whisper_tpu_torch.models.quantize import absmax_quantize, quantize_params
from whisper_tpu_torch.ops import fp8_upcast

pytestmark = pytest.mark.cuda

FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _assert_upcast_bitwise(x: torch.Tensor) -> None:
    before = fp8_upcast.launches
    got = fp8_upcast.dma_upcast(x)
    torch.cuda.synchronize()
    assert fp8_upcast.launches == before + (1 if x.numel() else 0)
    want = fp8_upcast.dma_upcast_reference(x)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


@pytest.mark.parametrize("dtype", FP8)
def test_every_code(card, dtype):
    codes = torch.arange(256, dtype=torch.int32, device=card).to(torch.uint8)
    _assert_upcast_bitwise(codes.view(dtype))
    _assert_upcast_bitwise(codes.repeat(80).view(dtype).reshape(80, 256))


@pytest.mark.parametrize("dtype", FP8)
def test_the_probe_plane(card, dtype):
    """One layer's cross K of the probe's defaults, [B·H·Dh, Tk] = [20480, 1500]."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((20480, 1500), generator=gen, device=card, dtype=torch.bfloat16).to(dtype)
    _assert_upcast_bitwise(x)


@pytest.mark.parametrize("shape", [(1, 1500), (1, 7), (3, 5, 7), (1000003,), (17,), (0, 16)])
def test_odd_counts_and_one_row(card, shape):
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=card).mul(64).to(torch.float8_e4m3fn)
    _assert_upcast_bitwise(x)


def test_refusals(card):
    x = torch.zeros((64, 1500), dtype=torch.float8_e4m3fn, device=card)
    for bad in (x[:, 1:], x.reshape(-1)[1:], x.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="fp8_upcast"):
            fp8_upcast.dma_upcast(bad)


def _reciprocal_differs(a: np.ndarray, d: float) -> np.ndarray:
    """Where ``a * (1/d)`` (PyTorch's CUDA divide by a host scalar) is not
    ``a / d`` in f32."""
    a = a.astype(np.float32)
    return a * (np.float32(1.0) / np.float32(d)) != a / np.float32(d)


def test_quantize_card_equals_host(card):
    rng = np.random.default_rng(0)
    amax = np.abs(rng.standard_normal(16384)).astype(np.float32)
    amax = amax[_reciprocal_differs(amax, 127.0)][:256]
    assert amax.size == 256
    # Each column's largest magnitude is one of those values.
    w = rng.uniform(-1.0, 1.0, (32, 256)).astype(np.float32) * amax
    w[rng.integers(0, 32, 256), np.arange(256)] = amax
    q_card, s_card = absmax_quantize(torch.from_numpy(w).to(card), (0,))
    q_host, s_host = absmax_quantize(torch.from_numpy(w), (0,))
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))  # JAX's numpy divide
    assert np.array_equal(s_card.cpu().numpy().view(np.int32), scale.view(np.int32))
    assert torch.equal(s_card.cpu(), s_host) and torch.equal(q_card.cpu(), q_host)
    # A whole tree, leaf by leaf.
    params = init_params(MODEL_DIMS["dev"], torch.Generator().manual_seed(3))
    on_card = quantize_params(to_device(params, card))
    on_host = quantize_params(params)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert torch.equal(a.cpu(), b), path

    walk(on_card, on_host, "")


def test_length_norm_card_equals_host(card):
    n = np.arange(1, 449, dtype=np.float32)
    assert _reciprocal_differs(5.0 + n, 6.0).any()
    gen_len = torch.from_numpy(n)
    # A penalty of 1.0 leaves the divide alone (pow by 1 is a copy).
    for penalty in (None, 1.0):
        got = beam.length_norm(gen_len.to(card), penalty).cpu()
        assert torch.equal(got, beam.length_norm(gen_len, penalty))
    want = (np.float32(5.0) + n) / np.float32(6.0)
    assert np.array_equal(beam.length_norm(gen_len.to(card), 1.0).cpu().numpy(), want)


def test_alignment_head_average_card_equals_host(card, monkeypatch):
    """``alignment_matrix`` ends with the selected heads' sum over their
    count (3 of dev's 4 here); the sum is replaced by values where
    ``x * (1/3)`` is not ``x / 3``, so the divide alone is held."""
    dims = MODEL_DIMS["dev"]
    rng = np.random.default_rng(1)
    b, t, ta = 1, 4, 8
    x = rng.standard_normal(4096).astype(np.float32)
    x = x[_reciprocal_differs(x, 3.0)][: b * t * ta].reshape(b, t, ta)
    monkeypatch.setattr(align, "all_reduce_model", lambda acc, tp: torch.from_numpy(x).to(acc.device))
    head_mask = np.array([[True, False], [True, True]])
    params = init_params(dims, torch.Generator().manual_seed(4))
    dh = dims.n_text_state // dims.n_text_head
    gen = torch.Generator().manual_seed(5)
    kv = {k: torch.randn((dims.n_text_layer, b, dims.n_text_head, dh, ta), generator=gen) for k in "kv"}
    tokens = torch.zeros((b, t), dtype=torch.int32)
    outs = []
    for dev in (card, torch.device("cpu")):
        params_d = to_device(params, dev)
        kv_d = {k: v.to(dev) for k, v in kv.items()}
        outs.append(align.alignment_matrix(params_d, tokens.to(dev), kv_d, dims, head_mask).cpu())
    assert torch.equal(outs[0], outs[1])
    assert np.array_equal(outs[0].numpy(), x / np.float32(3.0))
