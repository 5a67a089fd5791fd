"""whisper_tpu_torch.parallel against whisper_tpu.parallel, and the port's
data-parallel engine against JAX's mesh engine.

* Mesh and multihost helpers in one process: the mesh's shape, a world of
  the wrong size raises, ``host_shard``, ``uniform_host_rows``,
  ``local_batch`` and ``load_files_sharded`` equal to JAX's (whose single
  process holds the whole mesh), ``initialize`` a no-op.
* Two ranks on the CPU (two processes, gloo; ``parallel/_dist_worker``):
  ``mesh_shape=(2, 1)``, ``dev`` dims, f32, beam 3, under "hybrid" (K2′'s
  plain version) and "off". Every rank returns the same full result list,
  and its tokens, lengths and text EQUAL JAX's ``mesh_shape=(2, 1)`` engine
  and the port's single-process engine; ``avg_logprob`` to 1e-4.
* ``transcribe_files`` on two ranks, each reading only its files (3 files:
  an uneven split), and a one-file pass where rank 1 holds only padding:
  the counterpart of ``tests/test_multiprocess.py``. There a rank holds
  only its own rows, so ``audio_ctx="auto"`` is the full window on every
  rank (as in JAX); the references pin ``audio_ctx=None`` to crop alike.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.parallel import global_batch as jax_global_batch
from whisper_tpu.parallel import host_shard as jax_host_shard
from whisper_tpu.parallel import load_files_sharded as jax_load_files_sharded
from whisper_tpu.parallel import local_mesh_shape as jax_local_mesh_shape
from whisper_tpu.parallel import make_mesh as jax_make_mesh
from whisper_tpu.parallel.multihost import uniform_host_rows as jax_uniform_host_rows
from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.parallel import (
    Mesh,
    host_shard,
    initialize,
    load_files_sharded,
    local_batch,
    local_mesh_shape,
    make_mesh,
    uniform_host_rows,
)
from whisper_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(2)

CFG = dict(model="dev", dtype="float32", max_new_tokens=8, beam_size=3)


def _mesh(data: int, index: int = 0) -> Mesh:
    """One rank's view of a (data, 1) mesh, without a world."""
    return Mesh({"data": data, "model": 1}, ("data", "model"), index, torch.device("cpu"))


# --- mesh and multihost helpers -------------------------------------------


def test_mesh_shape():
    mesh = make_mesh((1, 1), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_index == 0
    assert mesh.device == torch.device("cpu") and mesh.data_size == 1
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}  # the world's size
    for n, mp in ((8, 1), (8, 2), (4, 4)):
        assert local_mesh_shape(n, mp) == jax_local_mesh_shape(n, mp)
    with pytest.raises(ValueError):
        local_mesh_shape(8, 3)


@pytest.mark.parametrize("shape", [(2, 1), (4, 2), (1, 2)])
def test_world_size_mismatch_raises(shape):
    with pytest.raises(ValueError, match="needs .* processes, have 1"):
        make_mesh(shape, device="cpu")


@pytest.mark.parametrize("shape", [None, (1, 1)])
def test_make_mesh_defaults_to_the_card_and_raises_without_one(monkeypatch, shape):
    # As JAX's make_mesh takes the accelerator, the port's takes the card:
    # without one (forced here, whatever the machine has) it raises the
    # engine's error rather than returning a CPU mesh.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        make_mesh(shape)


def test_local_rows():
    batch = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(_mesh(2, 1).local_rows(batch), batch[4:])
    np.testing.assert_array_equal(_mesh(4, 2).local_rows(batch), batch[4:6])


def test_host_shard_partitioning():
    spans = [host_shard(10, pi, 4) for pi in range(4)]
    assert spans == [jax_host_shard(10, pi, 4) for pi in range(4)]
    assert spans == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [i for s, e in spans for i in range(s, e)] == list(range(10))
    assert host_shard(2, 3, 4) == (2, 2)  # an over-provisioned rank: empty
    assert host_shard(5) == (0, 5)  # one process owns everything


def test_initialize_single_process_noop():
    initialize()
    initialize(None, 1, 0)
    initialize("127.0.0.1:1", 1, 0)  # one process: no group, nothing to reach
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n_items", [1, 3, 5, 8])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_uniform_host_rows_equal_to_jax(n_items, data):
    assert uniform_host_rows(n_items, _mesh(data)) == jax_uniform_host_rows(
        n_items, jax_make_mesh((data, 1))
    )


@pytest.mark.parametrize("pad_to", [None, 4])
def test_local_batch_padding_equal_to_jax(pad_to):
    local = np.arange(3 * 5, dtype=np.float32).reshape(3, 5) + 1
    ours = local_batch(local, _mesh(2), pad_to=pad_to)
    ref = np.asarray(jax_global_batch(local, jax_make_mesh((2, 1)), pad_to=pad_to))
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (4, 5) and not ours[3:].any()


def test_load_files_sharded(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"m{i}.wav")
        write_wav(p, (rng.normal(size=4000 - 500 * i) * 0.1).astype(np.float32))
        paths.append(p)
    rows, local_paths = load_files_sharded(paths, _mesh(4), max_len=4000)
    ref, ref_paths = jax_load_files_sharded(paths, jax_make_mesh((4, 1)), max_len=4000)
    assert local_paths == ref_paths == paths  # one process owns everything
    np.testing.assert_array_equal(rows, np.asarray(ref))
    assert rows.shape == (4, 4000) and rows.dtype == np.float32


# --- two ranks: the engine -------------------------------------------------


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _batch():
    x = np.zeros((4, 16_000 * 4), np.float32)
    for i, s in enumerate((4.0, 2.5, 3.5, 1.5)):
        a = _audio(s, i + 1)
        x[i, : len(a)] = a
    return x


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX engine's weights (PRNGKey 5: its random model gives rows
    that differ), and the same converted for the port in a file."""
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(**CFG).dims(), jax.random.PRNGKey(5)))
    path = str(tmp_path_factory.mktemp("weights") / "params.pt")
    torch.save(params_from_jax(tree), path)
    return tree, path


@pytest.fixture(scope="module")
def dp_batch(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_batch")
    np.save(d / "batch.npy", _batch())
    args = [
        "--npy", str(d / "batch.npy"), "--params", weights[1], "--model", "dev",
        "--device", "cpu", "--dtype", "float32", "--beam", "3", "--max-new", "8",
        "--fused-step", "hybrid,off", "--threads", "1",
    ]
    return launch(2, args, str(d), timeout=120)


def _as_rows(results):
    return [
        {"tokens": [int(t) for t in r.tokens[: r.length]], "length": int(r.length), "text": r.text}
        for r in results
    ]


def test_dp_ranks_hold_the_same_weights_and_results(dp_batch):
    assert [d["rank"] for d in dp_batch] == [0, 1] and all(d["world"] == 2 for d in dp_batch)
    assert dp_batch[0]["params_checksum"] == dp_batch[1]["params_checksum"]
    assert dp_batch[0]["audio_ctx"] == dp_batch[1]["audio_ctx"] == 256  # from the whole batch
    for mode in ("hybrid", "off"):
        assert dp_batch[0]["runs"][mode]["results"] == dp_batch[1]["runs"][mode]["results"]
        assert len(dp_batch[0]["runs"][mode]["results"]) == 4
        assert dp_batch[0]["runs"][mode]["steps"] > 0


@pytest.mark.parametrize("mode", ["hybrid", "off"])
def test_dp_engine_equal_to_jax_and_single_process(weights, dp_batch, mode):
    tree, _ = weights
    x = _batch()
    ref = jax_create_engine(
        JaxType.MONOLITH, JaxConfig(**CFG, fused_step="off", mesh_shape=(2, 1)), params=tree
    ).transcribe_batch(x)
    single = create_engine(
        EngineType.MONOLITH, EngineConfig(**CFG, fused_step=mode),
        params=params_from_jax(tree), device="cpu",
    ).transcribe_batch(x)
    got = dp_batch[0]["runs"][mode]["results"]
    assert [{k: g[k] for k in ("tokens", "length", "text")} for g in got] == _as_rows(ref)
    assert _as_rows(single) == _as_rows(ref)
    assert len({tuple(g["tokens"]) for g in got}) > 1  # the rows differ: a real check
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["avg_logprob"], r.avg_logprob, rtol=1e-4, atol=1e-4)


def test_engine_refuses_a_mesh_wider_than_the_world():
    cfg = dataclasses.replace(EngineConfig(model="dev"), mesh_shape=(2, 1))
    with pytest.raises(ValueError, match="needs 2 processes"):
        create_engine(EngineType.MONOLITH, cfg, device="cpu")


# --- two ranks: files -------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    paths = []
    for i, s in enumerate((3.0, 1.5, 2.5)):
        p = str(d / f"u{i}.wav")
        write_wav(p, _audio(s, i + 1))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def dp_files(weights, files, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_files")
    args = [
        "--paths", ",".join(files), "--params", weights[1], "--model", "dev",
        "--device", "cpu", "--dtype", "float32", "--beam", "3", "--max-new", "8",
        "--fused-step", "hybrid", "--threads", "1",
    ]
    return launch(2, args, str(d), timeout=120)


def test_two_process_files_equal_on_every_rank(weights, files, dp_files):
    tree, _ = weights
    cfg = dict(CFG, fused_step="off", audio_ctx=None)
    assert dp_files[0]["audio_ctx"] is None  # "auto" without the whole batch
    expected = _as_rows(jax_create_engine(
        JaxType.MONOLITH, JaxConfig(**cfg), params=tree).transcribe_files(files))
    single = _as_rows(create_engine(
        EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(tree), device="cpu",
    ).transcribe_files(files))
    runs = [d["runs"]["hybrid"] for d in dp_files]
    assert runs[0]["results"] == runs[1]["results"]
    assert [{k: g[k] for k in ("tokens", "length", "text")} for g in runs[0]["results"]] == expected
    assert single == expected


def test_one_file_uneven_probe(files, dp_files):
    """A one-file pass: rank 1 holds only padding, still runs and joins
    every gather, and every rank gets file 0's tokens of the full pass."""
    runs = [d["runs"]["hybrid"] for d in dp_files]
    first = runs[0]["results"][0]["tokens"]
    assert runs[0]["probe_single"] == runs[1]["probe_single"] == first
