"""whisper_tpu_torch.ops.gather (K4's plain version) against
whisper_tpu.ops.gather.permute_rows run in Pallas interpret mode.

A permutation moves bytes, so the two must agree BITWISE (compared as
uint8), in f32, bf16 and fp8, with duplicate indices. The window reorder
the beam loop uses equals the full reorder over the window.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.ops.gather import permute_rows as jax_permute_rows
from whisper_tpu_torch.decode.beam import reorder_cache, reorder_cache_window
from whisper_tpu_torch.ops import gather as tg

torch.set_num_threads(2)

DTYPES = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
}
IDX = np.array([3, 3, 0, 5, 5, 1], np.int32)  # duplicates: beam branching


def _pair(shape, dtype, seed=0):
    np_dt, t_dt = DTYPES[dtype]
    x = (4 * np.random.default_rng(seed).standard_normal(shape)).astype(np_dt)
    return x, torch.from_numpy(x.view(np.uint8)).view(t_dt)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_equals_jax_bitwise(dtype):
    x, t = _pair((3, 6, 8, 2, 64), dtype)
    ref = jax_permute_rows(jnp.asarray(x), jnp.asarray(IDX), interpret=True)
    before = tg.launches
    ours = tg.permute_rows(t, torch.from_numpy(IDX))
    assert tg.launches == before  # a CPU tensor takes the plain version
    assert ours.dtype == t.dtype and ours.shape == t.shape
    np.testing.assert_array_equal(_bytes(ours), _bytes(ref))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_out_and_window(dtype):
    _, t = _pair((2, 6, 9, 2, 8), dtype, seed=1)
    idx = torch.from_numpy(IDX)
    full = tg.permute_rows(t, idx)
    out = torch.zeros_like(t)
    assert tg.permute_rows(t[:, :, :5], idx, out=out[:, :, :5]).data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(_bytes(out[:, :, :5]), _bytes(full[:, :, :5]))
    assert not _bytes(out[:, :, 5:]).any()
    cache = {"k": t, "v": t.clone()}
    win = reorder_cache_window(cache, idx, 6, limit=5)
    whole = reorder_cache(cache, idx, 6)
    for n in "kv":
        np.testing.assert_array_equal(_bytes(win[n][:, :, :5]), _bytes(whole[n][:, :, :5]))
        np.testing.assert_array_equal(_bytes(win[n][:, :, 5:]), _bytes(cache[n][:, :, 5:]))


def test_refusals():
    x = torch.zeros(2, 6, 4)
    idx = torch.from_numpy(IDX)
    with pytest.raises(ValueError):
        tg.permute_rows(x, idx, out=x)  # rows repeat: not in place
    with pytest.raises(ValueError):
        tg.permute_rows(x, idx[:4])
    with pytest.raises(ValueError):
        tg.permute_rows(x, idx, out=torch.zeros(2, 6, 5))
    assert tg.supported(torch.zeros(2, 6, 4)) and not tg.supported(torch.zeros(2, 6, 3))
