"""whisper_tpu_torch.ops.fp8_upcast (K6) on the CPU against the TPU kernel
it ports, ``tools/probe_cross.py``'s ``_dma_upcast_kernel``, run in Pallas
interpret mode.

The tool builds its ``pallas_call`` only under ``PROBE_X=dmastage``, which
cannot lower on the CPU, so it is loaded under ``PROBE_X=prod`` at ``dev``
dims (``runpy``, the tool untouched), its kernel body is given ``pl`` and
``pltpu`` and wrapped in a ``pallas_call`` with the tool's specs, scratch
and chunk rule plus ``interpret=True``. Every fp8 value is exact in bf16,
so the port's plain version must equal it BITWISE, NaN codes NaN.
"""

import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from whisper_tpu_torch.ops import fp8_upcast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


@pytest.fixture(scope="module")
def tool_upcast():
    """The tool's kernel body in a ``pallas_call`` of its own specs, interpreted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROBE_X", "prod")
        mp.setenv("PROBE_TK", "16")
        mp.setenv("PROBE_ITERS", "1")
        mp.setattr(sys, "argv", ["probe_cross.py", "dev", "2", "2"])
        kern = runpy.run_path(os.path.join(REPO, "tools", "probe_cross.py"))["_dma_upcast_kernel"]
    kern.__globals__.update(pl=pl, pltpu=pltpu)

    def upcast(x2d):
        rows, tk = x2d.shape
        chunk = 64  # the tool's chunk rule
        while rows % chunk:
            chunk //= 2
        return pl.pallas_call(
            functools.partial(kern, rows=rows, chunk=chunk),
            grid=(rows // chunk,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            out_shape=jax.ShapeDtypeStruct((rows, tk), jnp.bfloat16),
            scratch_shapes=[
                pltpu.VMEM((2, chunk, tk), x2d.dtype),
                pltpu.VMEM((2, chunk, tk), jnp.bfloat16),
                pltpu.SemaphoreType.DMA((2,)),
                pltpu.SemaphoreType.DMA((2,)),
            ],
            compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024),
            interpret=True,
        )(x2d)

    return upcast


def _both(codes: np.ndarray, dtype: str):
    """The same fp8 bytes as a JAX array and a torch tensor."""
    x = torch.from_numpy(codes).view(TORCH_FP8[dtype])
    return jnp.asarray(codes.view(getattr(jnp, dtype))), x


def _assert_bitwise(tool_out, port_out: torch.Tensor):
    """Bits equal where the value is not NaN; NaN where the tool's is."""
    want = np.asarray(tool_out).view(np.uint16)
    got = port_out.view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(np.asarray(tool_out).astype(np.float32))
    assert np.array_equal(got[~nan], want[~nan])
    assert torch.isnan(port_out.float()).numpy()[nan].all()
    return int(nan.sum())


# The NaN codes, read from the bits: e4m3fn's are S.1111.111, e5m2's S.11111.xx with xx != 0.
NAN_CODE = {
    "float8_e4m3fn": lambda c: (c & 0x7F) == 0x7F,
    "float8_e5m2": lambda c: (c & 0x7F) > 0x7C,
}


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("rows, tk", [(128, 16), (96, 32), (40, 64), (2, 128)])  # chunk 64, 32, 8, 2
def test_every_code_equals_the_tool_kernel(tool_upcast, dtype, rows, tk):
    codes = np.resize(np.arange(256, dtype=np.uint8), (rows, tk))
    x_jax, x = _both(codes, dtype)
    before = fp8_upcast.launches
    port = fp8_upcast.dma_upcast(x)
    assert fp8_upcast.launches == before  # the plain version on the CPU: nothing launched
    assert port.dtype == torch.bfloat16 and port.shape == (rows, tk)
    assert torch.equal(port.view(torch.int16), fp8_upcast.dma_upcast_reference(x).view(torch.int16))
    assert _assert_bitwise(tool_upcast(x_jax), port) == int(NAN_CODE[dtype](codes).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_random_plane_equals_the_tool_kernel(tool_upcast, seed):
    """A plane drawn as the probe draws its K and V: bf16 normals cast to fp8."""
    rng = np.random.default_rng(seed)
    vals = jnp.asarray(rng.standard_normal((64, 48)), jnp.bfloat16).astype(jnp.float8_e4m3fn)
    x = torch.from_numpy(np.array(vals).view(np.uint8)).view(torch.float8_e4m3fn)
    assert _assert_bitwise(tool_upcast(vals), fp8_upcast.dma_upcast(x)) == 0


def test_any_shape_and_odd_counts():
    rng = np.random.default_rng(2)
    for shape in [(3, 5, 7), (1, 17), (33,), (0, 16)]:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.float8_e4m3fn)
        y = fp8_upcast.dma_upcast(x)
        assert y.shape == x.shape and torch.equal(y.float(), x.float())


@pytest.mark.parametrize(
    "make",
    [
        lambda x: x.to(torch.bfloat16),  # a 2-byte store: the TPU kernel's copy is not ported
        lambda x: x.float(),
        lambda x: x[:, 1:],  # a sliced view: not contiguous
        lambda x: x.reshape(-1)[1:],  # contiguous, base 1 byte past a 16-byte boundary
    ],
    ids=["bfloat16", "float32", "sliced", "misaligned"],
)
def test_refusals(make):
    x = torch.zeros((4, 64), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="fp8_upcast"):
        fp8_upcast.dma_upcast(make(x))
