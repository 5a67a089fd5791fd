"""K2′ (whisper_tpu_torch.ops.fused_step.permute_append_sharded) and the
hybrid beam step on a data-parallel mesh, against whisper_tpu.

* K2′'s plain version, run shard by shard for 4 shards, BITWISE (uint8)
  equal to JAX ``permute_append_sharded`` on a (4, 1) CPU mesh with its
  Pallas kernel in interpret mode (the case of ``tests/test_fused_step.py``
  ``test_permute_append_sharded_byte_exact``), in f32, bf16 and fp8, both
  parities: over rows [0, pos] of the write plane, the read plane and the
  other layers. ``localize`` is JAX's ``(r // K) * K + rem(idx, K)``.
* ``resolve_fused(tp=2)`` as ``tests/test_fused_step.py`` pins JAX's.
* A rank's hybrid step: ``decoder_step_fused(sharded=True)`` with global
  source rows equals the step with local rows BITWISE, and
  ``beam_decode(mesh=...)`` hands K2′ global rows only (rank 1 of 2),
  with tokens equal to the same rows decoded without a mesh.
* Two ranks on the CPU (two processes, gloo): the engine at ``dev`` f32,
  beam 3, ``mesh_shape=(2, 1)``, under "hybrid": tokens and lengths equal
  JAX's ``mesh_shape=(2, 1)`` engine under "hybrid" (its ``beam_decode(fused=
  "hybrid", mesh=...)``, K2′ per shard) and the port's single-process
  engine; ``avg_logprob`` to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from whisper_tpu.config import MODEL_DIMS
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode.beam import resolve_fused as jax_resolve_fused
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.ops.fused_step import permute_append_sharded as jax_permute_append_sharded
from whisper_tpu_torch.config import MODEL_DIMS as T_DIMS
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode import beam as tbeam
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models import decoder as tdec
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.ops import fused_step as tf
from whisper_tpu_torch.parallel import Mesh
from whisper_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(2)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# --- K2′ against JAX -----------------------------------------------------


@pytest.mark.parametrize(
    "np_dt, t_dt",
    [
        (np.float32, torch.float32),
        (ml_dtypes.bfloat16, torch.bfloat16),
        (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    ],
    ids=["f32", "bf16", "fp8"],
)
@pytest.mark.parametrize("parity", [0, 1])
def test_sharded_reference_equals_jax_per_shard(np_dt, t_dt, parity):
    beam, shards, b, ctx, hd, n_layer, layer, pos = 2, 4, 4, 16, 128, 2, 1, 5
    bk = b * beam
    rng = np.random.default_rng(0)
    ck, cv = ((2 * rng.standard_normal((2, n_layer, bk, ctx, hd))).astype(np_dt) for _ in range(2))
    kn, vn = (rng.standard_normal((bk, hd)).astype(np.float32) for _ in range(2))
    # Global rows, within each sample (the only shape beam selection emits):
    # a duplicate, a swap, identities.
    idx = np.array([1, 1, 2, 3, 5, 4, 7, 7], np.int32)
    mesh = JaxMesh(np.array(jax.devices()[:shards]).reshape(shards, 1), ("data", "model"))
    jk, jv = jax_permute_append_sharded(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx), jnp.int32(layer), jnp.int32(pos),
        jnp.int32(parity), jnp.asarray(kn), jnp.asarray(vn),
        mesh=mesh, data_axis="data", beam=beam, interpret=True,
    )
    per = bk // shards
    w = 1 - parity
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        tk, tv = (torch.from_numpy(x[:, :, rows].copy().view(np.uint8)).view(t_dt) for x in (ck, cv))
        before = tf.sharded_launches
        ok, ov = tf.permute_append_sharded(
            tk, tv, torch.from_numpy(idx[rows].copy()), layer, pos, parity,
            torch.from_numpy(kn[rows].copy()), torch.from_numpy(vn[rows].copy()), beam=beam,
        )
        assert tf.sharded_launches == before and ok is tk and ov is tv  # plain version, in place
        for ours, ref, orig in ((ok, jk, ck), (ov, jv, cv)):
            ours, ref, orig = _bytes(ours), _bytes(ref)[:, :, rows], _bytes(orig)[:, :, rows]
            np.testing.assert_array_equal(ours[w, layer, :, : pos + 1], ref[w, layer, :, : pos + 1])
            np.testing.assert_array_equal(ours[parity], orig[parity])
            np.testing.assert_array_equal(ours[w, :layer], orig[w, :layer])
            np.testing.assert_array_equal(ours[w, layer + 1 :], orig[w, layer + 1 :])


def test_localize_is_jax_rule():
    rng = np.random.default_rng(1)
    beam, bk = 5, 10
    idx = rng.integers(-7, 40, size=bk).astype(np.int32)  # negatives: rem truncates
    own = (np.arange(bk, dtype=np.int32) // beam) * beam
    ref = np.asarray(own + jax.lax.rem(jnp.asarray(idx), jnp.int32(beam)))
    np.testing.assert_array_equal(tf.localize(torch.from_numpy(idx), beam).numpy(), ref)


def test_sharded_refusals():
    planes = torch.zeros(2, 2, 6, 8, 16)
    new = torch.zeros(6, 16)
    idx = torch.arange(6, dtype=torch.int32)
    for beam in (4, 0):  # 6 rows are not whole samples of 4; no beam
        with pytest.raises(ValueError, match="whole samples"):
            tf.permute_append_sharded(planes, planes.clone(), idx, 0, 1, 0, new, new, beam=beam)
    bad = idx.clone()
    bad[0] = -1  # localises to row -1, outside the shard
    with pytest.raises(IndexError):
        tf.permute_append_sharded(planes, planes.clone(), bad, 0, 1, 0, new, new, beam=3)


# --- resolve_fused -------------------------------------------------------


def test_tp_mesh_refuses_hybrid():
    dims = T_DIMS["dev"]
    args = (dims, "cpu", torch.float32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        tbeam.resolve_fused("hybrid", *args, tp=2)
    with pytest.raises(ValueError, match="tensor-parallel"):
        jax_resolve_fused("hybrid", MODEL_DIMS["dev"], tp=2)
    for fused in ("auto", True, "lineage", "off"):
        ours = tbeam.resolve_fused(fused, *args, tp=2)
        assert ours == jax_resolve_fused(fused, MODEL_DIMS["dev"], tp=2)
    assert tbeam.resolve_fused("auto", dims, "cuda", torch.float8_e4m3fn, tp=2) == "off"
    assert tbeam.resolve_fused("auto", dims, "cuda", torch.float8_e4m3fn, tp=1) == "hybrid"
    assert tbeam.resolve_fused(True, dims, "cuda", torch.float8_e4m3fn, tp=2) == "off"


# --- a rank's hybrid step -------------------------------------------------

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=48)
T_DEV = dataclasses.replace(T_DIMS["dev"], n_audio_ctx=48)


@pytest.fixture(scope="module")
def dev_tree():
    return jax.tree.map(np.asarray, jax_init_params(DIMS, jax.random.PRNGKey(0)))


def test_sharded_step_equals_local_step_bitwise(dev_tree):
    """Rank 1 of 2: rows 4..7 of a B=4, K=2 batch. K2′ with global source
    rows gives the logits and planes of K2 with the same rows numbered
    locally, over steps with an identity, a swap and a duplicate."""
    params = params_from_jax(dev_tree)
    beam, b, p_len, ctx, row0 = 2, 2, 3, 16, 4
    bk = b * beam
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal((b, 48, 64)).astype(np.float32))
    cross = tdec.precompute_cross_kv(params, enc, T_DEV)
    cache = tdec.init_kv_cache(T_DEV, b, ctx)
    _, cache = tdec.decoder_prefill(params, torch.arange(p_len).repeat(b, 1), cache, cross, T_DEV)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 100, (3, bk)))
    perms = [np.arange(bk), np.array([1, 0, 3, 3]), np.array([0, 0, 2, 3])]
    runs = []
    for offset, sharded in ((0, False), (row0, True)):
        planes = tdec.plane_cache_from_prefill(cache, beam)
        pending, parity, out = torch.arange(bk, dtype=torch.int32) + offset, 0, []
        for step, perm in enumerate(perms):
            logits, planes = tdec.decoder_step_fused(
                params, toks[step], p_len + step, planes, parity, pending, cross, T_DEV,
                beam_width=beam, sharded=sharded,
            )
            parity, pending = 1 - parity, torch.from_numpy(perm).int() + offset
            out.append(logits)
        runs.append((out, planes))
    (a, pa), (c, pc) = runs
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    for n in "kv":
        assert torch.equal(pa[n][:, :, :, : p_len + 3], pc[n][:, :, :, : p_len + 3])


def test_beam_decode_on_a_mesh_sends_global_rows(dev_tree, monkeypatch):
    params = params_from_jax(dev_tree)
    b, beam = 4, 3
    enc = torch.from_numpy(
        (0.3 * np.random.default_rng(3).standard_normal((b, 48, 64))).astype(np.float32)
    )
    prompt = torch.tensor([[7, 11]]).repeat(b, 1)
    kw = dict(dims=T_DEV, eot=5, max_new_tokens=9, beam_size=beam, fused="hybrid")
    mesh = Mesh({"data": 2, "model": 1}, ("data", "model"), 1, torch.device("cpu"))
    seen = []
    real = tf.permute_append_sharded

    def spy(ck, cv, idx, *args, **kwargs):
        seen.append(idx.clone())
        return real(ck, cv, idx, *args, **kwargs)

    monkeypatch.setattr(tf, "permute_append_sharded", spy)
    monkeypatch.setattr(tf, "permute_append", None)  # K2 must not run on a mesh
    rows = slice(2, 4)  # rank 1's share: beam rows 6..11
    steps = tbeam.steps
    got = tbeam.beam_decode(params, enc[rows], prompt[rows], mesh=mesh, **kw)
    steps = tbeam.steps - steps
    monkeypatch.undo()
    want = tbeam.beam_decode(params, enc[rows], prompt[rows], **kw)
    assert steps > 0 and len(seen) == T_DEV.n_text_layer * steps
    idx = torch.stack(seen)
    assert int(idx.min()) >= 6 and int(idx.max()) < 12
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# --- two ranks on the CPU ---------------------------------------------------

CFG = dict(model="dev", dtype="float32", max_new_tokens=8, beam_size=3)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def test_two_process_hybrid_equal_to_jax_mesh(tmp_path):
    x = np.zeros((4, 16_000 * 4), np.float32)
    for i, s in enumerate((4.0, 2.5, 3.5, 1.5)):
        a = _audio(s, i + 1)
        x[i, : len(a)] = a
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(**CFG).dims(), jax.random.PRNGKey(5)))
    np.save(tmp_path / "batch.npy", x)
    torch.save(params_from_jax(tree), tmp_path / "params.pt")
    reports = launch(2, [
        "--npy", str(tmp_path / "batch.npy"), "--params", str(tmp_path / "params.pt"),
        "--model", "dev", "--device", "cpu", "--dtype", "float32", "--beam", "3",
        "--max-new", "8", "--fused-step", "hybrid", "--threads", "1",
    ], str(tmp_path), timeout=120)
    ref = jax_create_engine(
        JaxType.MONOLITH, JaxConfig(**CFG, fused_step="hybrid", mesh_shape=(2, 1)), params=tree
    ).transcribe_batch(x)
    single = create_engine(
        EngineType.MONOLITH, EngineConfig(**CFG, fused_step="hybrid"),
        params=params_from_jax(tree), device="cpu",
    ).transcribe_batch(x)
    got = [r["runs"]["hybrid"]["results"] for r in reports]
    assert got[0] == got[1]
    for g, r, s in zip(got[0], ref, single):
        assert g["tokens"] == r.tokens[: r.length].tolist() == s.tokens[: s.length].tolist()
        assert g["length"] == r.length == s.length
        np.testing.assert_allclose(g["avg_logprob"], r.avg_logprob, rtol=1e-4, atol=1e-4)
