"""The rank-sliced restore (``utils/checkpoint.load_params(path, mesh)``, the
counterpart of JAX's ``load_params_orbax(path, mesh)``) on the CPU.

* For every rank of the meshes (1, 2) and (2, 2), the restored slice equals
  ``shard_params`` of the whole tree bit for bit: float32, bfloat16 and
  int8 trees at ``dev`` and ``tiny``, an npz written by whisper_tpu's
  ``save_params``, and a compressed npz (``np.savez_compressed``). A float
  file under ``quantization="int8"`` equals ``shard_params`` of
  ``quantize_params`` of the whole tree, also when a weight cut across its
  scale's span is read in many blocks of output channels.
* The host holds the slice, not the tree: a tracemalloc peak during the
  restore of one rank of (1, 2) stays below 0.6 of the tree's bytes at
  ``tiny``.
* Two CPU ranks of ``parallel/_dist_worker --checkpoint`` on (1, 2) each
  hold the slice of the whole tree (checksum) and decode the tokens of one
  process built on the whole tree, greedy and beam 3 with int8 weights
  quantised as the file is read. (The CLI's ``--checkpoint`` with ``--mesh
  1,2`` restores through the same path: ``tests/test_torch_tensor_parallel.py``
  runs it under ``torchrun`` against the single process's text.)
* The engine refuses a float slice under ``quantization="int8"``.
* ``models.params.count_params`` equals JAX's ``count_params``.
"""

import tracemalloc

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import MODEL_DIMS as J_DIMS
from whisper_tpu.models.params import count_params as jax_count_params
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.models.quantize import quantize_params as jax_quantize
from whisper_tpu.utils import checkpoint as jckpt
from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import cast_params, count_params, init_params, params_from_jax
from whisper_tpu_torch.models.quantize import param_bytes, quantize_params
from whisper_tpu_torch.parallel._dist_worker import launch, params_checksum
from whisper_tpu_torch.parallel.mesh import Mesh
from whisper_tpu_torch.parallel.sharding import shard_params
from whisper_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


def assert_same(a, b, path="params"):
    """Two port parameter trees: the same structure, dtypes and bytes."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)), path


def ranks(shape):
    """Every rank's mesh of a (data, model) shape, numbered as
    ``parallel.mesh.make_mesh`` numbers them (the model axis innermost)."""
    d, m = shape
    return [
        Mesh(shape={"data": d, "model": m}, axis_names=("data", "model"), data_index=r // m,
             device=torch.device("cpu"), model_index=r % m)
        for r in range(d * m)
    ]


def _tree(model, kind):
    params = init_params(MODEL_DIMS[model], torch.Generator().manual_seed(7))
    if kind == "bfloat16":
        return cast_params(params, torch.bfloat16)
    if kind == "int8":
        return quantize_params(params)
    return params


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(model, kind): npz path} written by the port's ``save_params``."""
    d = tmp_path_factory.mktemp("restore")
    out = {}
    for model in ("dev", "tiny"):
        for kind in ("float32", "bfloat16", "int8"):
            out[model, kind] = str(d / f"{model}_{kind}.npz")
            checkpoint.save_params(out[model, kind], _tree(model, kind), MODEL_DIMS[model])
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("model", ["dev", "tiny"])
def test_slice_equals_the_cut_of_the_whole_tree(files, model, kind, shape):
    path = files[model, kind]
    whole, dims = checkpoint.load_params(path)
    assert dims == MODEL_DIMS[model]
    assert_same(whole, _tree(model, kind))
    for mesh in ranks(shape):
        sliced, _ = checkpoint.load_params(path, mesh)
        assert_same(sliced, shard_params(whole, mesh, dims))


@pytest.mark.parametrize("block", [checkpoint._BLOCK_ELEMENTS, 3000])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["dev", "tiny"])
def test_float_file_quantised_as_it_is_read(files, model, kind, block, monkeypatch):
    """A float file under int8 equals the whole tree quantised, then cut;
    with small blocks a row-parallel weight and the embedding are read in
    many blocks of output channels."""
    monkeypatch.setattr(checkpoint, "_BLOCK_ELEMENTS", block)
    path = files[model, kind]
    whole, dims = checkpoint.load_params(path)
    want = quantize_params(whole)
    assert_same(checkpoint.load_params(path, quantization="int8")[0], want)
    for mesh in ranks((2, 2))[:2]:
        sliced, _ = checkpoint.load_params(path, mesh, quantization="int8")
        assert_same(sliced, shard_params(want, mesh, dims))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_jax_written_and_compressed_files(tmp_path, kind):
    """An npz of whisper_tpu's ``save_params``, and the same arrays in a
    compressed npz (read whole, member by member), restore to the cut of
    ``params_from_jax`` of JAX's tree."""
    tree = jax_init_params(J_DIMS["dev"], jax.random.PRNGKey(9))
    if kind == "bfloat16":
        tree = jax.tree.map(lambda x: x.astype(jax.numpy.bfloat16), tree)
    if kind == "int8":
        tree = jax_quantize(tree)
    tree = jax.tree.map(np.asarray, tree)
    stored = str(tmp_path / "jax.npz")
    jckpt.save_params(stored, tree, J_DIMS["dev"])
    compressed = str(tmp_path / "compressed.npz")
    with np.load(stored) as data:
        np.savez_compressed(compressed, **{k: data[k] for k in data.files})
    whole = params_from_jax(tree)
    dims = MODEL_DIMS["dev"]
    for path in (stored, compressed):
        assert_same(checkpoint.load_params(path)[0], whole)
        for mesh in ranks((2, 2)):
            assert_same(checkpoint.load_params(path, mesh)[0], shard_params(whole, mesh, dims))
    assert not checkpoint._members(compressed)["encoder/conv1/b"].stored
    assert checkpoint._members(stored)["encoder/conv1/b"].stored


@pytest.mark.parametrize("kind, quantization", [("float32", None), ("int8", None), ("float32", "int8")])
def test_restore_holds_a_slice_not_the_tree(files, kind, quantization):
    path = files["tiny", kind]
    mesh = ranks((1, 2))[1]
    checkpoint.load_params(files["dev", kind], mesh, quantization=quantization)  # imports done
    whole = param_bytes(_tree("tiny", kind))
    tracemalloc.start()
    try:
        sliced, _ = checkpoint.load_params(path, mesh, quantization=quantization)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 0.6 * whole, (peak, whole)
    target = quantize_params(_tree("tiny", kind)) if quantization else _tree("tiny", kind)
    assert param_bytes(sliced) < 0.55 * param_bytes(target)


def test_engine_refuses_to_quantise_a_float_slice(files):
    sliced, _ = checkpoint.load_params(files["dev", "float32"], ranks((1, 2))[0])
    with pytest.raises(ValueError, match="float model slice"):
        create_engine(EngineType.MONOLITH, EngineConfig(model="dev", dtype="float32", quantization="int8"),
                      params=sliced, device="cpu", shard=(0, 2))


def test_count_params_equals_jax():
    tree = jax_init_params(J_DIMS["dev"], jax.random.PRNGKey(3))
    assert count_params(params_from_jax(jax.tree.map(np.asarray, tree))) == jax_count_params(tree)
    q = jax_quantize(tree)
    assert count_params(params_from_jax(jax.tree.map(np.asarray, q))) == jax_count_params(q)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    return (0.2 * np.sin(2 * np.pi * (220 + 60 * seed) * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


WORKER_CONFIGS = {
    "greedy": ([], {}),
    "beam3_int8": (["--beam", "3", "--fused-step", "off", "--quantization", "int8"],
                   dict(beam_size=3, fused_step="off", quantization="int8")),
}


@pytest.mark.parametrize("name", sorted(WORKER_CONFIGS))
def test_worker_ranks_restore_their_slices(files, tmp_path, name):
    flags, over = WORKER_CONFIGS[name]
    path = files["dev", "float32"]
    batch = np.zeros((2, 16_000 * 3), np.float32)
    for i, s in enumerate((3.0, 2.0)):
        a = _audio(s, i)
        batch[i, : len(a)] = a
    np.save(tmp_path / "batch.npy", batch)
    reports = launch(2, [
        "--npy", str(tmp_path / "batch.npy"), "--checkpoint", path, "--model", "dev",
        "--device", "cpu", "--dtype", "float32", "--mesh", "1,2", "--max-new", "6",
        "--threads", "1", *flags,
    ], str(tmp_path), timeout=180)
    whole, dims = checkpoint.load_params(path)
    cfg = EngineConfig(model="dev", dtype="float32", max_new_tokens=6, **over)
    single = create_engine(EngineType.MONOLITH, cfg, params=whole, device="cpu")
    want = [r.tokens[: r.length].tolist() for r in single.transcribe_batch(batch)]
    for rep, mesh in zip(reports, ranks((1, 2))):
        assert rep["restore_ms"] > 0
        assert rep["params_checksum"] == params_checksum(shard_params(single.assets.params, mesh, dims))
        mode = "off" if "--fused-step" in flags else "auto"
        assert [g["tokens"] for g in rep["runs"][mode]["results"]] == want
