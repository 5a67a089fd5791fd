"""whisper_tpu_torch.ops.gather_attend (K3's plain version) against
whisper_tpu.ops.fused_step.fused_gather_attend.

* ``fused_gather_attend`` on the CPU (its plain version) against JAX's
  Pallas kernel in interpret mode, at JAX's test shapes (BK 8, ctx 32, H 4,
  Dh 16): f32; bf16; fp8 storage with a bf16 query; both parities; ``idx``
  with duplicates, all zeros and the identity; pos 0 and 9. The write
  plane's window ``[0, pos]`` BITWISE (uint8), the read plane and the
  other layers untouched, ``attn`` to JAX's own tolerances
  (tests/test_fused_step.py: f32 1e-5, bf16 3e-2, fp8 5e-2).
* The port's ``reference_gather_attend`` against JAX's: the same window
  bitwise, ``attn`` to the same tolerances.
* Within the port, the write planes of ``fused_gather_attend_reference``
  and of K2's plain version are bitwise equal.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.ops.fused_step import fused_gather_attend as jax_fused_gather_attend
from whisper_tpu.ops.fused_step import reference_gather_attend as jax_reference_gather_attend
from whisper_tpu_torch.ops import fused_step as tf
from whisper_tpu_torch.ops import gather_attend as ga

torch.set_num_threads(2)

BK, CTX, H, DH, N_LAYER, LAYER = 8, 32, 4, 16, 3, 1
HD = H * DH
# name: (numpy storage, torch storage, numpy query, torch query, JAX's tolerance)
DTYPES = {
    "f32": (np.float32, torch.float32, np.float32, torch.float32, 1e-5),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16, ml_dtypes.bfloat16, torch.bfloat16, 3e-2),
    "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, ml_dtypes.bfloat16, torch.bfloat16, 5e-2),
}
IDX = {
    "duplicates": np.array([3, 3, 0, 5, 7, 1, 1, 4], np.int32),
    "zeros": np.zeros(BK, np.int32),  # every beam branches from row 0
    "identity": np.arange(BK, dtype=np.int32),  # the greedy case
}


# JAX's kernel in interpret mode, jitted: idx, pos and parity are traced, so
# the cases of one dtype share one compile (an eager interpret call costs
# seconds).
JAX_KERNEL = jax.jit(functools.partial(jax_fused_gather_attend, n_head=H, interpret=True))


def _torch(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)).view(dtype).reshape(x.shape)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _inputs(dname, seed=0):
    np_dt, t_dt, np_q, t_q, _ = DTYPES[dname]
    rng = np.random.default_rng(seed)
    ck, cv = (rng.standard_normal((2, N_LAYER, BK, CTX, HD)).astype(np.float32).astype(np_dt) for _ in range(2))
    q = rng.standard_normal((BK, HD)).astype(np.float32).astype(np_q)
    kn, vn = (rng.standard_normal((BK, HD)).astype(np.float32) for _ in range(2))
    return ck, cv, q, kn, vn


def _port_args(ck, cv, q, kn, vn, idx, dname):
    _, t_dt, _, t_q, _ = DTYPES[dname]
    return (_torch(ck, t_dt), _torch(cv, t_dt), torch.from_numpy(idx), _torch(q, t_q),
            torch.from_numpy(kn), torch.from_numpy(vn))


def _jax_args(ck, cv, q, kn, vn, idx, pos, parity):
    return (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(LAYER), jnp.int32(pos),
            jnp.int32(parity), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))


def _assert_planes(ours, ref, orig, pos, parity):
    w = 1 - parity
    ours, ref, orig = _bytes(ours), _bytes(ref), _bytes(orig)
    np.testing.assert_array_equal(ours[w, LAYER, :, : pos + 1], ref[w, LAYER, :, : pos + 1])
    np.testing.assert_array_equal(ours[parity], orig[parity])
    np.testing.assert_array_equal(ours[w, :LAYER], orig[w, :LAYER])
    np.testing.assert_array_equal(ours[w, LAYER + 1 :], orig[w, LAYER + 1 :])


@pytest.mark.parametrize("pos", [0, 9])
@pytest.mark.parametrize("idx_kind", sorted(IDX))
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_fused_gather_attend_equals_jax(dname, parity, idx_kind, pos):
    ck, cv, q, kn, vn = _inputs(dname)
    idx = IDX[idx_kind]
    ja, jk, jv = JAX_KERNEL(*_jax_args(ck, cv, q, kn, vn, idx, pos, parity))
    tk, tv, tidx, tq, tkn, tvn = _port_args(ck, cv, q, kn, vn, idx, dname)
    before = ga.launches
    attn, ok, ov = ga.fused_gather_attend(tk, tv, tidx, LAYER, pos, parity, tq, tkn, tvn, n_head=H)
    assert ga.launches == before and ok is tk and ov is tv  # plain version, in place
    assert attn.shape == (BK, HD) and attn.dtype == tq.dtype
    tol = DTYPES[dname][4]
    np.testing.assert_allclose(attn.float().numpy(), np.asarray(ja, np.float32), atol=tol, rtol=tol)
    for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
        _assert_planes(ours, ref, orig, pos, parity)


@pytest.mark.parametrize("pos", [0, 9])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_reference_gather_attend_equals_jax(dname, pos):
    ck, cv, q, kn, vn = _inputs(dname, seed=1)
    idx = IDX["duplicates"]
    ja, jk, jv = jax_reference_gather_attend(*_jax_args(ck, cv, q, kn, vn, idx, pos, 0), n_head=H)
    tk, tv, tidx, tq, tkn, tvn = _port_args(ck, cv, q, kn, vn, idx, dname)
    attn, ok, ov = ga.reference_gather_attend(tk, tv, tidx, LAYER, pos, 0, tq, tkn, tvn, n_head=H)
    tol = DTYPES[dname][4]
    np.testing.assert_allclose(attn.float().numpy(), np.asarray(ja, np.float32), atol=tol, rtol=tol)
    for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
        _assert_planes(ours, ref, orig, pos, 0)
    # The fused arithmetic and the oracle's agree within the same tolerance.
    fa, _, _ = ga.fused_gather_attend(*_port_args(ck, cv, q, kn, vn, idx, dname)[:3], LAYER, pos, 0,
                                      tq, tkn, tvn, n_head=H)
    np.testing.assert_allclose(fa.float().numpy(), attn.float().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_planes_equal_to_permute_append(dname):
    ck, cv, q, kn, vn = _inputs(dname, seed=2)
    idx = IDX["duplicates"]
    fk, fv, tidx, tq, tkn, tvn = _port_args(ck, cv, q, kn, vn, idx, dname)
    pk, pv = fk.clone(), fv.clone()
    ga.fused_gather_attend_reference(fk, fv, tidx, LAYER, 9, 1, tq, tkn, tvn, n_head=H)
    tf.permute_append_reference(pk, pv, tidx, LAYER, 9, 1, tkn, tvn)
    for a, b in ((fk, pk), (fv, pv)):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


def test_refusals_and_supported():
    planes = torch.zeros(2, 2, 4, 8, 16)
    idx = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros(4, 16)
    call = lambda *a, n_head=2: ga.fused_gather_attend(*a, n_head=n_head)  # noqa: E731
    with pytest.raises(ValueError):
        call(planes, planes.clone(), idx, 2, 1, 0, x, x, x)  # layer
    with pytest.raises(ValueError):
        call(planes, planes.clone(), idx, 0, 8, 0, x, x, x)  # pos
    with pytest.raises(ValueError):
        call(planes, planes.clone(), idx[:3], 0, 1, 0, x, x, x)
    with pytest.raises(ValueError):
        call(planes, planes.clone(), idx, 0, 1, 0, x[:, :8], x, x)  # q
    with pytest.raises(ValueError):
        call(planes, planes.clone(), idx, 0, 1, 0, x, x, x, n_head=3)  # heads
    # large-v3 fp8/bf16, tiny f32, dev fp8 (Dh 32) and JAX's test shape fp8 (Dh 16)
    assert ga.supported(1280, 1, 20) and ga.supported(1280, 2, 20) and ga.supported(384, 4, 6)
    assert ga.supported(64, 1, 2) and ga.supported(64, 1, 4)
    assert not ga.supported(96, 2, 2)  # 96-byte slices: 6 vectors, not a power of two
    assert not ga.supported(24, 1, 2) and not ga.supported(256, 4, 1)  # 12 bytes; 1 KB
