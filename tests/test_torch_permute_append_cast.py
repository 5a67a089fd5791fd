"""K2 and K2′ (whisper_tpu_torch.ops.fused_step) with new rows in another
dtype than the planes, against whisper_tpu, and the table of dtype pairs
the CUDA kernel converts.

* The plain K2 with bf16 and f16 rows into fp8, bf16 and f32 planes,
  BITWISE (uint8) equal to JAX ``permute_append`` (its Pallas kernel in
  interpret mode; the rows cast with ``astype`` before its append), both
  parities, over rows [0, pos] of the write plane, the read plane and the
  other layers. The same for the plain K2′ per shard against JAX
  ``permute_append_sharded`` on a (4, 1) CPU mesh. In-range values: the
  fp8 cast differs between PyTorch and ml_dtypes beyond ±448 (ROADMAP
  Queue 3).
* Strided rows (a column slice of a wider tensor, a view at an odd
  offset) give the bytes of their contiguous copy.
* ``CAST_PAIRS``, the pairs the CUDA kernel converts, and its dtype codes,
  which must be those of ``csrc/store_cast.cuh``; the plain version stores
  ``.to()``'s bytes for every pair; ``_kernel_args`` hands the kernel the
  rows' own pointer, strides and dtype code, and refuses every other pair.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from whisper_tpu.ops.fused_step import permute_append as jax_permute_append
from whisper_tpu.ops.fused_step import permute_append_sharded as jax_permute_append_sharded
from whisper_tpu_torch.ops import fused_step as tf

torch.set_num_threads(2)

NP_OF = {
    torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16,
    torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
}
ROWS = [torch.bfloat16, torch.float16]
PLANES = [torch.float8_e4m3fn, torch.bfloat16, torch.float32]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The same bytes as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(dtype)


def _inputs(planes_dt, rows_dt, bk, n_layer, ctx, hd, seed):
    rng = np.random.default_rng(seed)
    ck, cv = ((2 * rng.standard_normal((2, n_layer, bk, ctx, hd))).astype(NP_OF[planes_dt])
              for _ in range(2))
    kn, vn = (rng.standard_normal((bk, hd)).astype(NP_OF[rows_dt]) for _ in range(2))
    return ck, cv, kn, vn


def _assert_contract(ours, ref, orig, layer, pos, parity):
    w = 1 - parity
    np.testing.assert_array_equal(ours[w, layer, :, : pos + 1], ref[w, layer, :, : pos + 1])
    np.testing.assert_array_equal(ours[parity], orig[parity])
    np.testing.assert_array_equal(ours[w, :layer], orig[w, :layer])
    np.testing.assert_array_equal(ours[w, layer + 1 :], orig[w, layer + 1 :])


@pytest.mark.parametrize("rows_dt", ROWS, ids=["bf16 rows", "f16 rows"])
@pytest.mark.parametrize("planes_dt", PLANES, ids=["fp8", "bf16", "f32"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_k2_equals_jax(rows_dt, planes_dt, parity):
    bk, n_layer, ctx, hd, layer, pos = 8, 3, 24, 64, 1, 11
    ck, cv, kn, vn = _inputs(planes_dt, rows_dt, bk, n_layer, ctx, hd, seed=7)
    idx = np.array([3, 3, 0, 5, 7, 1, 1, 4], np.int32)
    jk, jv = jax_permute_append(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(layer), jnp.int32(pos),
        jnp.int32(parity), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
    )
    tk, tv = _torch(ck, planes_dt), _torch(cv, planes_dt)
    before = tf.launches
    ok, ov = tf.permute_append(tk, tv, torch.from_numpy(idx), layer, pos, parity,
                               _torch(kn, rows_dt), _torch(vn, rows_dt))
    assert tf.launches == before and ok is tk and ov is tv  # plain version, in place
    for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
        _assert_contract(_bytes(ours), _bytes(ref), _bytes(orig), layer, pos, parity)


@pytest.mark.parametrize("rows_dt", ROWS, ids=["bf16 rows", "f16 rows"])
@pytest.mark.parametrize("planes_dt", PLANES, ids=["fp8", "bf16", "f32"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_k2_sharded_equals_jax_per_shard(rows_dt, planes_dt, parity):
    beam, shards, b, ctx, hd, n_layer, layer, pos = 2, 4, 4, 16, 128, 2, 1, 6
    bk = b * beam
    ck, cv, kn, vn = _inputs(planes_dt, rows_dt, bk, n_layer, ctx, hd, seed=8)
    idx = np.array([1, 1, 2, 3, 5, 4, 7, 7], np.int32)  # global rows within each sample
    mesh = JaxMesh(np.array(jax.devices()[:shards]).reshape(shards, 1), ("data", "model"))
    jk, jv = jax_permute_append_sharded(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(layer), jnp.int32(pos),
        jnp.int32(parity), jnp.asarray(kn), jnp.asarray(vn),
        mesh=mesh, data_axis="data", beam=beam, interpret=True,
    )
    per = bk // shards
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        tk, tv = (_torch(x[:, :, rows], planes_dt) for x in (ck, cv))
        before = tf.sharded_launches
        ok, ov = tf.permute_append_sharded(
            tk, tv, torch.from_numpy(idx[rows].copy()), layer, pos, parity,
            _torch(kn[rows], rows_dt), _torch(vn[rows], rows_dt), beam=beam,
        )
        assert tf.sharded_launches == before and ok is tk and ov is tv
        for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
            _assert_contract(_bytes(ours), _bytes(ref)[:, :, rows], _bytes(orig)[:, :, rows],
                             layer, pos, parity)


@pytest.mark.parametrize("kind", ["column slice", "odd offset"])
@pytest.mark.parametrize("rows_dt, planes_dt", [
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float16),
], ids=["bf16-fp8", "f32-bf16", "f16-f16"])
def test_strided_rows_give_the_bytes_of_their_contiguous_copy(kind, rows_dt, planes_dt):
    bk, hd, pos = 6, 96, 9
    gen = torch.Generator().manual_seed(4)
    if kind == "column slice":
        wide = torch.randn((2, bk, 3 * hd), generator=gen).to(rows_dt)
        kn, vn = wide[0, :, 5 : 5 + hd], wide[1, :, hd + 1 : 2 * hd + 1]
        assert not kn.is_contiguous()
    else:
        flat = torch.randn(2 * bk * hd + 1, generator=gen).to(rows_dt)
        kn, vn = flat[1 : bk * hd + 1].view(bk, hd), flat[bk * hd + 1 :].view(bk, hd)
    planes = [torch.randn((2, 2, bk, 16, hd), generator=gen).mul(4).to(planes_dt) for _ in range(2)]
    ref = [p.clone() for p in planes]
    idx = torch.tensor([2, 2, 0, 5, 1, 1], dtype=torch.int32)
    tf.permute_append(*planes, idx, 1, pos, 0, kn, vn)
    tf.permute_append(*ref, idx, 1, pos, 0, kn.contiguous(), vn.contiguous())
    for got, want in zip(planes, ref):
        np.testing.assert_array_equal(_bytes(got[1, 1, :, : pos + 1]), _bytes(want[1, 1, :, : pos + 1]))


def test_cast_pairs_table_and_codes():
    floats = (torch.float32, torch.bfloat16, torch.float16)
    fp8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    want = {(r, s) for r in floats for s in floats + fp8} | {(s, s) for s in fp8}
    assert tf.CAST_PAIRS == want and len(want) == 17
    assert tf.ROW_DTYPES == floats and set(tf.DTYPE_CODES) == set(floats + fp8)
    header = (Path(tf.__file__).parent.parent / "csrc" / "store_cast.cuh").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d+)", re.search(r"enum Dtype[^}]*}", header).group(0)))
    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float8_e4m3fn: "E4M3", torch.float8_e5m2: "E5M2"}
    assert {names[d]: str(c) for d, c in tf.DTYPE_CODES.items()} == enum


@pytest.mark.parametrize("pair", sorted(tf.CAST_PAIRS, key=str), ids=lambda p: f"{str(p[0])[6:]}->{str(p[1])[6:]}")
def test_plain_version_stores_to_bytes_for_every_pair(pair):
    rows_dt, planes_dt = pair
    bk, hd, pos = 4, 32, 3
    rows = torch.randn((bk, hd), generator=torch.Generator().manual_seed(5)).mul(3).to(rows_dt)
    planes = [torch.zeros((2, 1, bk, 8, hd)).to(planes_dt) for _ in range(2)]
    tf.permute_append(*planes, torch.arange(bk, dtype=torch.int32), 0, pos, 1, rows, rows)
    for p in planes:
        np.testing.assert_array_equal(_bytes(p[0, 0, :, pos]), _bytes(rows.to(planes_dt)))


def test_kernel_args_pass_the_rows_as_they_are():
    bk, hd = 4, 64
    planes = [torch.zeros((2, 3, bk, 8, hd), dtype=torch.float8_e4m3fn) for _ in range(2)]
    idx = torch.arange(bk, dtype=torch.int32)
    wide = torch.zeros((bk, 3 * hd), dtype=torch.bfloat16)
    kn, vn = wide[:, 7 : 7 + hd], torch.zeros((hd, bk), dtype=torch.bfloat16).t()
    args = tf._kernel_args(*planes, idx, 2, 5, 1, kn, vn)
    assert args[:4] == (planes[0].data_ptr(), planes[1].data_ptr(), kn.data_ptr(), vn.data_ptr())
    assert args[4:8] == (3 * hd * 2, 1, 2, bk)  # row strides in bytes, element strides
    assert args[8:11] == (tf.DTYPE_CODES[torch.bfloat16], tf.DTYPE_CODES[torch.float8_e4m3fn],
                          int(tf.e4m3_saturates()))
    assert args[11:] == (idx.data_ptr(), 3, bk, 8, hd, 1, 2, 5, 1)


def test_e4m3_overflow_rule_is_the_installed_torch_one():
    """The kernel stores e4m3 overflow as this PyTorch's ``.to()`` does:
    ±448 where it saturates, ±NaN (0x7F) where it does not."""
    over = torch.tensor([480.0, -1e6, float("inf"), 470.0]).to(torch.float8_e4m3fn).view(torch.uint8)
    want = [0x7E, 0xFE, 0x7E, 0x7E] if tf.e4m3_saturates() else [0x7F, 0xFF, 0x7F, 0x7F]
    assert over.tolist() == want
    assert torch.tensor([448.0, 464.0]).to(torch.float8_e4m3fn).view(torch.uint8).tolist() == [0x7E, 0x7E]


@pytest.mark.parametrize("k_dt, v_dt, planes_dt", [
    (torch.float64, torch.float64, torch.float8_e4m3fn),  # a row dtype the kernel does not read
    (torch.float8_e5m2, torch.float8_e5m2, torch.float8_e4m3fn),  # fp8 rows go raw only
    (torch.float8_e4m3fn, torch.float8_e4m3fn, torch.float32),
    (torch.float32, torch.bfloat16, torch.float8_e4m3fn),  # K and V rows in two dtypes
    (torch.float32, torch.float32, torch.float64),  # a storage dtype the kernel does not write
], ids=["f64 rows", "e5m2 into e4m3", "e4m3 into f32", "two row dtypes", "f64 planes"])
def test_kernel_args_refuse_other_pairs(k_dt, v_dt, planes_dt):
    bk, hd = 4, 64
    planes = [torch.zeros((2, 1, bk, 8, hd), dtype=planes_dt) for _ in range(2)]
    idx = torch.arange(bk, dtype=torch.int32)
    with pytest.raises(TypeError):
        tf._kernel_args(*planes, idx, 0, 1, 0, torch.zeros((bk, hd), dtype=k_dt),
                        torch.zeros((bk, hd), dtype=v_dt))
