"""K3 (whisper_tpu_torch.ops.gather_attend) with new rows in another dtype
than the planes, against whisper_tpu, and the arguments its CUDA kernel
receives.

* The plain K3 with f32, bf16 and f16 rows into fp8, bf16 and f32 planes
  against JAX ``fused_gather_attend`` (its Pallas kernel in interpret mode;
  the rows cast with ``astype`` in its epilogue), both parities: the write
  plane's window [0, pos], the read plane and the other layers BITWISE
  (uint8), ``attn`` to JAX's own tolerances (tests/test_fused_step.py: f32
  1e-5, bf16 3e-2, fp8 5e-2). In-range values: the fp8 cast differs
  between PyTorch and ml_dtypes beyond ±448 (ROADMAP Queue 3).
* ``_kernel_args`` hands the kernel the rows' own pointers, strides and
  dtype codes (K2's, ``csrc/store_cast.cuh``), with no copy, and refuses
  every pair outside ``CAST_PAIRS`` and every plane dtype the kernel does
  not read.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.ops.fused_step import fused_gather_attend as jax_fused_gather_attend
from whisper_tpu_torch.ops import fused_step as tf
from whisper_tpu_torch.ops import gather_attend as ga

torch.set_num_threads(2)

BK, CTX, H, DH, N_LAYER, LAYER, POS = 8, 24, 4, 16, 3, 1, 11
HD = H * DH
NP_OF = {
    torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16,
    torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
}
ROWS = [torch.float32, torch.bfloat16, torch.float16]
# planes: (query dtype, JAX's tolerance)
PLANES = {
    torch.float8_e4m3fn: (torch.bfloat16, 5e-2),
    torch.bfloat16: (torch.bfloat16, 3e-2),
    torch.float32: (torch.float32, 1e-5),
}

JAX_KERNEL = jax.jit(functools.partial(jax_fused_gather_attend, n_head=H, interpret=True))


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The same bytes as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(dtype).reshape(a.shape)


@pytest.mark.parametrize("rows_dt", ROWS, ids=["f32 rows", "bf16 rows", "f16 rows"])
@pytest.mark.parametrize("planes_dt", list(PLANES), ids=["fp8", "bf16", "f32"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_k3_equals_jax(rows_dt, planes_dt, parity):
    q_dt, tol = PLANES[planes_dt]
    rng = np.random.default_rng(11)
    ck, cv = ((2 * rng.standard_normal((2, N_LAYER, BK, CTX, HD))).astype(NP_OF[planes_dt]) for _ in range(2))
    q = rng.standard_normal((BK, HD)).astype(np.float32).astype(NP_OF[q_dt])
    kn, vn = (rng.standard_normal((BK, HD)).astype(NP_OF[rows_dt]) for _ in range(2))
    idx = np.array([3, 3, 0, 5, 7, 1, 1, 4], np.int32)
    ja, jk, jv = JAX_KERNEL(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(LAYER), jnp.int32(POS),
        jnp.int32(parity), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
    )
    tk, tv = _torch(ck, planes_dt), _torch(cv, planes_dt)
    before = ga.launches
    attn, ok, ov = ga.fused_gather_attend(
        tk, tv, torch.from_numpy(idx), LAYER, POS, parity, _torch(q, q_dt),
        _torch(kn, rows_dt), _torch(vn, rows_dt), n_head=H,
    )
    assert ga.launches == before and ok is tk and ov is tv  # plain version, in place
    assert attn.dtype == q_dt
    np.testing.assert_allclose(attn.float().numpy(), np.asarray(ja, np.float32), atol=tol, rtol=tol)
    w = 1 - parity
    for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
        ours, ref, orig = _bytes(ours), _bytes(ref), _bytes(orig)
        np.testing.assert_array_equal(ours[w, LAYER, :, : POS + 1], ref[w, LAYER, :, : POS + 1])
        np.testing.assert_array_equal(ours[parity], orig[parity])
        np.testing.assert_array_equal(ours[w, :LAYER], orig[w, :LAYER])
        np.testing.assert_array_equal(ours[w, LAYER + 1 :], orig[w, LAYER + 1 :])


def _operands(planes_dt=torch.float8_e4m3fn, q_dt=torch.bfloat16, bk=4, hd=64, ctx=8):
    planes = [torch.zeros((2, 3, bk, ctx, hd), dtype=planes_dt) for _ in range(2)]
    idx = torch.arange(bk, dtype=torch.int32)
    q = torch.zeros((bk, hd), dtype=q_dt)
    return planes, idx, q, torch.empty_like(q)


def test_kernel_args_pass_the_rows_as_they_are():
    (ck, cv), idx, q, out = _operands()
    bk, hd = q.shape
    wide = torch.zeros((bk, 3 * hd), dtype=torch.float16)
    kn, vn = wide[:, 7 : 7 + hd], torch.zeros((hd, bk), dtype=torch.float16).t()
    args = ga._kernel_args(ck, cv, idx, 2, 5, 1, q, kn, vn, out, 4)
    assert args[:4] == (ck.data_ptr(), cv.data_ptr(), kn.data_ptr(), vn.data_ptr())
    assert args[4:8] == (3 * hd * 2, 1, 2, bk)  # row strides in bytes, element strides
    assert args[8:12] == (tf.DTYPE_CODES[torch.float16], 2, tf.DTYPE_CODES[torch.float8_e4m3fn],
                          int(tf.e4m3_saturates()))
    assert args[12:16] == (idx.data_ptr(), q.data_ptr(), out.data_ptr(), tf.DTYPE_CODES[torch.bfloat16])
    assert args[16:24] == (3, bk, 8, hd, 4, 2, 5, 1)
    assert args[24] == pytest.approx(16**-0.5)
    # Rows already in the storage dtype go raw, at their own address.
    rows = torch.zeros((bk, hd + 1), dtype=torch.float8_e4m3fn)[:, 1:]
    args = ga._kernel_args(ck, cv, idx, 0, 1, 0, q, rows, rows, out, 4)
    assert args[2] == rows.data_ptr() and args[4:10] == (hd + 1, 1, hd + 1, 1, 3, 1)


@pytest.mark.parametrize("k_dt, v_dt, planes_dt", [
    (torch.float64, torch.float64, torch.float8_e4m3fn),  # a row dtype the kernel does not read
    (torch.float8_e5m2, torch.float8_e5m2, torch.float8_e4m3fn),  # fp8 rows go raw only
    (torch.float8_e4m3fn, torch.float8_e4m3fn, torch.float32),
    (torch.float32, torch.bfloat16, torch.float8_e4m3fn),  # K and V rows in two dtypes
    (torch.float32, torch.float32, torch.float16),  # a storage dtype K3 does not read
    (torch.float32, torch.float32, torch.float8_e5m2),
], ids=["f64 rows", "e5m2 into e4m3", "e4m3 into f32", "two row dtypes", "f16 planes", "e5m2 planes"])
def test_kernel_args_refuse_other_pairs(k_dt, v_dt, planes_dt):
    (ck, cv), idx, q, out = _operands(planes_dt)
    bk, hd = q.shape
    with pytest.raises(TypeError):
        ga._kernel_args(ck, cv, idx, 0, 1, 0, q, torch.zeros((bk, hd), dtype=k_dt),
                        torch.zeros((bk, hd), dtype=v_dt), out, 4)


def test_every_cast_pair_into_k3_planes_is_taken():
    pairs = {(r, s) for r, s in tf.CAST_PAIRS if s in ga.STORAGE_DTYPES}
    assert len(pairs) == 10  # f32, bf16, f16 rows into three planes, and fp8 rows raw
    for rows_dt, planes_dt in pairs:
        (ck, cv), idx, q, out = _operands(planes_dt)
        rows = torch.zeros(q.shape, dtype=rows_dt)
        assert ga._kernel_args(ck, cv, idx, 0, 1, 0, q, rows, rows, out, 4)[8] == tf.DTYPE_CODES[rows_dt]


def test_window_must_fit_in_shared_memory():
    # Where the window passes four passes, V's goes to shared memory: the
    # flagship's whole 448-token context fits in bf16, a long f32 one not.
    assert ga._shared_bytes(447, 1280, 2, 20) < ga._SHARED_BYTES
    # Registers: of the window, only the scores take shared memory.
    assert ga._shared_bytes(67, 1280, 1, 20) - ga._shared_bytes(0, 1280, 1, 20) == 17 * 16
    (ck, cv), idx, q, out = _operands(torch.float32, torch.float32, bk=2, hd=128, ctx=1024)
    rows = torch.zeros(q.shape)
    assert ga._kernel_args(ck, cv, idx, 0, 400, 0, q, rows, rows, out, 1)
    with pytest.raises(ValueError):
        ga._kernel_args(ck, cv, idx, 0, 1000, 0, q, rows, rows, out, 1)
