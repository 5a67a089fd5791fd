"""K1, the encoder's fused self-attention: whisper_tpu_torch.ops.attention
against whisper_tpu.ops.attention.

On the CPU the JAX side runs ``fused_self_attention(..., use_flash=False)``
(the einsum path its own CPU runs take) and the port's wrapper runs its plain
version. Tolerances: float32 atol 1e-5; bfloat16 one bf16 ulp of the output
scale (2^-7 relative to max|ref|), since the two frameworks round the
weights and the output at the same places but sum in another order.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by ``test_torch_attention_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.attention import fused_self_attention as jax_fused
from whisper_tpu_torch.ops import attention as ta

torch.set_num_threads(2)


def _inputs(t, h=2, dh=64, b=1, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [1, 100, 1500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_jax(t, dtype):
    q, k, v = _inputs(t, seed=t)
    ref = jax_fused(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)), use_flash=False
    )
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    ours = ta.fused_self_attention_reference(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    )
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (1, t, 2, 64)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0**-7 * float(np.abs(ref).max())
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2.0**-7, atol=tol)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(ta, "_library", no_library)
    q, k, v = (torch.from_numpy(x) for x in _inputs(37, dh=32))
    before = ta.launches
    out = ta.fused_self_attention(q, k, v)
    assert ta.launches == before
    torch.testing.assert_close(out, ta.fused_self_attention_reference(q, k, v), rtol=0, atol=0)


class _OnCuda:
    """A CPU tensor that reports a CUDA device: drives the wrapper's CUDA
    branch on a machine without a card."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize(
    "dh, dtype, err",
    [(48, torch.bfloat16, ValueError), (128, torch.float32, ValueError),
     (64, torch.float16, TypeError)],
)
def test_cuda_branch_raises_for_unsupported_inputs(monkeypatch, dh, dtype, err):
    def no_library():
        raise AssertionError("must raise before reaching the kernel")

    monkeypatch.setattr(ta, "_library", no_library)
    q = _OnCuda(torch.zeros(1, 8, 2, dh, dtype=dtype))
    before = ta.launches
    with pytest.raises(err):
        ta.fused_self_attention(q, q, q)
    assert ta.launches == before


def test_cuda_branch_raises_for_strided_head_dim(monkeypatch):
    monkeypatch.setattr(ta, "_library", lambda: None)
    x = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)[..., ::2]  # Dh 64, stride 2
    with pytest.raises(ValueError, match="contiguous"):
        ta.fused_self_attention(_OnCuda(x), _OnCuda(x), _OnCuda(x))


def test_other_devices_raise_rather_than_fall_back():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ta.fused_self_attention(q, q, q)
