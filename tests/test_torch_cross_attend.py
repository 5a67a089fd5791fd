"""whisper_tpu_torch.ops.cross_attend on the CPU: its plain version against
the port's ``cross_attention_T`` as it was before the kernel (copied below,
BITWISE) and against JAX's ``cross_attention_T`` (``test_torch_layers.py``'s
bf16 tolerance: about one bf16 ulp of the output's scale); its launch plan;
its refusals; and the decoder's ``_cross_block``, BITWISE as before.

Shapes: stored K/V in bf16, float8_e4m3fn and float8_e5m2; 1 query a row
(a greedy step), 5 (a beam step), 4 (a prompt), 20 (beam 5 × a prompt of
4) and 17 (one past a block's tile of 16 queries); Tk 1500, 375 (an odd
crop) and 1; 20 heads and 10 (a tensor-parallel rank's). The kernel itself
is held to this plain version on the card, in
``tests/test_torch_cross_attend_cuda.py``.
"""

import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from whisper_tpu.models import layers as jl
from whisper_tpu_torch.models import decoder
from whisper_tpu_torch.models import layers as tl
from whisper_tpu_torch.ops import cross_attend

torch.set_num_threads(2)

STORES = {
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
    "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2),
}
TQ = [1, 5, 4, 20, 17]
TK = [1500, 375, 1]
HEADS = [20, 10]
ULP = 2.0**-7


def seed_cross_attention_T(q, kT, vT):
    """The port's ``models/layers.cross_attention_T`` before the kernel, verbatim."""
    if kT.element_size() == 1:
        kT = kT.to(q.dtype)
    if vT.element_size() == 1:
        vT = vT.to(q.dtype)
    dh = q.shape[-1]
    qt = q.transpose(1, 2)  # [B, H, Tq, Dh]
    scores = torch.matmul(qt.float(), kT.float()) * (1.0 / float(dh) ** 0.5)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(vT.dtype), vT.transpose(-1, -2))  # [B, H, Tq, Dh]
    return out.transpose(1, 2).to(vT.dtype)


def _inputs(store: str, tq: int, tk: int, heads: int, b: int = 2, seed: int = 0):
    """(q, kT, vT) as numpy float32 holding exact bf16 and stored values,
    and the torch tensors in bf16 and the store's dtype."""
    rng = np.random.default_rng(seed + 1000 * tq + tk + heads)
    q = rng.standard_normal((b, tq, heads, 64)).astype(ml_dtypes.bfloat16).astype(np.float32)
    kv = [(2.0 * rng.standard_normal((b, heads, 64, tk))).astype(STORES[store][1]).astype(np.float32)
          for _ in range(2)]
    t_store = STORES[store][0]
    return (q, *kv), (torch.from_numpy(q).to(torch.bfloat16),
                      *(torch.from_numpy(x).to(t_store) for x in kv))


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("tk", TK)
@pytest.mark.parametrize("tq", TQ)
@pytest.mark.parametrize("store", list(STORES))
def test_plain_version_is_cross_attention_T_bitwise(store, tq, tk, heads):
    _, (q, kT, vT) = _inputs(store, tq, tk, heads)
    want = seed_cross_attention_T(q, kT, vT)
    assert want.dtype == torch.bfloat16 and want.shape == q.shape
    for got in (cross_attend.cross_attend_reference(q, kT, vT), tl.cross_attention_T(q, kT, vT),
                cross_attend.cross_attend(q, kT, vT)):
        assert torch.equal(got, want)
    assert cross_attend.launches == 0  # CPU tensors: the plain version, nothing launched


@pytest.mark.parametrize("tk", TK)
@pytest.mark.parametrize("tq", TQ)
@pytest.mark.parametrize("store", list(STORES))
def test_plain_version_matches_jax(store, tq, tk):
    (qn, kn, vn), (q, kT, vT) = _inputs(store, tq, tk, 10, b=1, seed=1)
    dt = STORES[store][1]
    ref = np.asarray(jl.cross_attention_T(jnp.asarray(qn, jnp.bfloat16), jnp.asarray(kn.astype(dt)),
                                          jnp.asarray(vn.astype(dt))).astype(jnp.float32))
    ours = cross_attend.cross_attend_reference(q, kT, vT).float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=ULP, atol=ULP * float(np.abs(ref).max()))


def test_float32_parity_dtype_keeps_the_plain_version():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 64)).astype(np.float32))
    kT, vT = (torch.from_numpy(rng.standard_normal((2, 4, 64, 30)).astype(np.float32)) for _ in range(2))
    assert not cross_attend.routes(q)
    assert torch.equal(tl.cross_attention_T(q, kT, vT), seed_cross_attention_T(q, kT, vT))


@pytest.mark.parametrize(
    "q_dtype,dh,kv_dtype,routed,refusal",
    [(torch.bfloat16, 64, torch.bfloat16, True, None), (torch.bfloat16, 64, torch.float8_e4m3fn, True, None),
     (torch.bfloat16, 64, torch.float8_e5m2, True, None), (torch.float32, 64, torch.float32, False, None),
     (torch.float32, 64, torch.float8_e4m3fn, False, None),
     (torch.bfloat16, 32, torch.bfloat16, True, r"\[B, Tq, H, 64\]"),
     (torch.bfloat16, 64, torch.float16, True, "K and V must both")],
)
def test_routes(q_dtype, dh, kv_dtype, routed, refusal):
    """The route is the query's dtype alone: a bf16 call the kernel does not
    take (head size, store) is refused, never sent to the plain version.
    The refusal is the wrapper's own check, the same on either device."""
    q = torch.zeros((1, 1, 2, dh), dtype=q_dtype)
    kT = torch.zeros((1, 2, dh, 3), dtype=kv_dtype)
    assert cross_attend.routes(q) is routed
    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            cross_attend.cross_attend(q, kT, kT)
    elif routed:
        assert cross_attend.cross_attend(q, kT, kT).shape == q.shape


@pytest.mark.parametrize(
    "tq,tk,itemsize,ptrs,want",
    [
        (5, 1500, 1, (0, 0), cross_attend.Plan(1, 4)),  # the flagship's step
        (1, 1500, 2, (0, 0), cross_attend.Plan(1, 4)),  # turbo's
        (8, 512, 2, (0, 0), cross_attend.Plan(1, 4)),
        (9, 1500, 1, (0, 0), cross_attend.Plan(2, 4)),
        (20, 1500, 1, (0, 0), cross_attend.Plan(2, 4)),
        (17, 375, 1, (0, 0), cross_attend.Plan(2, 1)),
        (5, 1, 2, (0, 0), cross_attend.Plan(1, 1)),
        (5, 1500, 1, (2, 0), cross_attend.Plan(1, 2)),  # a base 2 bytes off
        (5, 1500, 2, (0, 4), cross_attend.Plan(1, 2)),  # 4 bytes off: 2 bf16 keys
        (5, 1500, 2, (0, 2), cross_attend.Plan(1, 1)),
        (5, 1502, 1, (0, 0), cross_attend.Plan(1, 2)),
    ],
)
def test_plan(tq, tk, itemsize, ptrs, want):
    assert cross_attend.plan(tq, tk, itemsize, *ptrs) == want


def _refused(q, kT, vT, match):
    with pytest.raises(ValueError, match=match):
        cross_attend.cross_attend(q, kT, vT)


def test_refusals():
    _, (q, kT, vT) = _inputs("float8_e4m3fn", 5, 64, 2)
    _refused(q.float(), kT, vT, "bfloat16 query")  # dtype
    _refused(q, kT.to(torch.float16), vT.to(torch.float16), "K and V must both")
    _refused(q, kT, vT.to(torch.bfloat16), "K and V must both")
    _refused(q[..., :32].contiguous(), kT[:, :, :32].contiguous(), vT[:, :, :32].contiguous(),
             r"\[B, Tq, H, 64\]")  # Dh
    _refused(q, kT.permute(0, 3, 1, 2).contiguous(), vT.permute(0, 3, 1, 2).contiguous(),
             "stored layout")  # [B, Tk, H, Dh]
    _refused(q, kT.transpose(-1, -2).contiguous().transpose(-1, -2), vT, "K must be contiguous")
    wide = torch.zeros((2, 2, 64, 100), dtype=torch.float8_e4m3fn)
    _refused(q, wide[..., :64], vT, "K must be contiguous")  # a crop that is a strided view
    _refused(q, kT, wide[..., 36:], "V must be contiguous")
    _refused(torch.zeros((2, 5, 2, 128), dtype=torch.bfloat16)[..., ::2], kT, vT,
             "q's head dim must be contiguous")  # any other strides of q are taken


def _block(rng, d, dtype):
    def dense(bias=True):
        p = {"w": torch.from_numpy((rng.standard_normal((d, d)) * d**-0.5).astype(np.float32)).to(dtype)}
        if bias:
            p["b"] = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(dtype)
        return p

    ln = {"g": torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)),
          "b": torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))}
    return {"ln2": ln, "cross": {"q": dense(), "o": dense()}}


def _seed_cross_block(bp, x, n_head, xk_l, xv_l, beam_width):
    """``models/decoder._cross_block`` before the kernel, over the copy above."""
    hn = tl.layer_norm(bp["ln2"], x)
    qx = tl.split_heads(tl.linear(bp["cross"]["q"], hn), n_head)
    bk, t, h, dh = qx.shape
    out = seed_cross_attention_T(
        qx.reshape(bk // beam_width, beam_width * t, h, dh), xk_l, xv_l
    ).reshape(bk, t, h, dh)
    return x + tl.linear(bp["cross"]["o"], tl.merge_heads(out))


@pytest.mark.parametrize(
    "compute,store,beam_width,t",
    [(c, s, w, t) for (c, s), w, t in itertools.product(
        [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float8_e4m3fn"),
         ("float32", "float8_e4m3fn")], [1, 5], [1, 4])],
)
def test_cross_block_unchanged_on_the_cpu(compute, store, beam_width, t):
    rng = np.random.default_rng(7)
    n_head, b, tk = 2, 2, 75
    dtype = getattr(torch, compute)
    bp = _block(rng, n_head * 64, dtype)
    x = torch.from_numpy(rng.standard_normal((b * beam_width, t, n_head * 64)).astype(np.float32)).to(dtype)
    xk, xv = (torch.from_numpy(rng.standard_normal((b, n_head, 64, tk)).astype(np.float32))
              .to(getattr(torch, store)) for _ in range(2))
    got = decoder._cross_block(bp, x, n_head, xk, xv, beam_width)
    assert torch.equal(got, _seed_cross_block(bp, x, n_head, xk, xv, beam_width))
