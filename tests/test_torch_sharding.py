"""whisper_tpu_torch.parallel.sharding against whisper_tpu.parallel.sharding.

* ``param_pspecs`` and ``quantize_pspecs`` equal JAX's specs leaf by leaf:
  the port's leaf is the axis the model axis cuts, JAX's the position of
  ``"model"`` in its ``PartitionSpec`` (less one inside the stacked
  ``blocks``, whose leading layer axis the port's per-layer list drops).
* ``shard_params``: every rank's slices, concatenated on their axis, give
  back the whole tree (float and int8); replicated leaves are the same
  tensors; a degree that does not divide the heads raises as in JAX.
* Quantise-then-shard: the scales a rank holds equal the unsharded tree's
  (a row-parallel weight's per-output scale runs over the whole of d_in,
  which scales taken per shard would not).
* The activation specs, the mesh's model coordinates, and the collectives
  as no-ops without a model axis.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from whisper_tpu.config import MODEL_DIMS as JAX_DIMS
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_tpu.models.quantize import quantize_pspecs as jax_quantize_pspecs
from whisper_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.models.params import init_params, leaves
from whisper_tpu_torch.models.quantize import absmax_quantize, quantize_params, quantize_pspecs
from whisper_tpu_torch.parallel import collectives
from whisper_tpu_torch.parallel.mesh import Mesh
from whisper_tpu_torch.parallel.sharding import (
    param_pspecs,
    shard_params,
)

torch.set_num_threads(2)


def _mesh(m: int, i: int = 0) -> Mesh:
    """Rank i's view of a (1, m) mesh, without a world."""
    return Mesh({"data": 1, "model": m}, ("data", "model"), 0, torch.device("cpu"), i)


def _axis(spec: P, stacked: bool):
    """The axis a JAX spec puts ``model`` on, in the port's layout."""
    entries = tuple(spec)
    if "model" not in entries:
        return None
    return entries.index("model") - (1 if stacked else 0)


def _same_specs(ours, ref, stacked=False, path="") -> None:
    """Walk the port's spec tree against JAX's, leaf by leaf."""
    if isinstance(ref, P):
        assert ours == _axis(ref, stacked), path
        return
    if isinstance(ours, list):  # the port's per-layer blocks against JAX's stack
        assert len(ours) > 0
        for i, layer in enumerate(ours):
            _same_specs(layer, ref, True, f"{path}[{i}]")
        return
    assert set(ours) == set(ref), path
    for k in ref:
        _same_specs(ours[k], ref[k], stacked, f"{path}.{k}")


@pytest.mark.parametrize("model", ["dev", "tiny", "large-v3"])
def test_param_pspecs_equal_to_jax(model):
    _same_specs(param_pspecs(MODEL_DIMS[model]), jax_param_pspecs(JAX_DIMS[model]))


@pytest.mark.parametrize("model", ["dev", "tiny"])
def test_quantize_pspecs_equal_to_jax(model):
    dims = MODEL_DIMS[model]
    jax_tree = jax_quantize_params(jax_init_params(JAX_DIMS[model], jax.random.PRNGKey(0)))
    ref = jax_quantize_pspecs(jax_param_pspecs(JAX_DIMS[model]), jax_tree)
    ours = quantize_pspecs(param_pspecs(dims), quantize_params(init_params(dims, torch.Generator().manual_seed(0))))
    _same_specs(ours, ref)
    # The three rules, spelled out on one block.
    blk = ours["decoder"]["blocks"][0]
    assert blk["attn"]["q"] == {"w_q": 1, "w_s": 0, "b": 0}  # column: the scale with d_out
    assert blk["mlp"]["fc2"] == {"w_q": 0, "w_s": None, "b": None}  # row: the scale whole
    assert ours["decoder"]["tok_emb"] == {"q": 1, "s": None}  # the row scale [V] whole


def _tree(model: str, quantized: bool):
    params = init_params(MODEL_DIMS[model], torch.Generator().manual_seed(3))
    return quantize_params(params) if quantized else params


def _regroup(shards, spec):
    """The m ranks' trees merged back: cut leaves concatenated on their
    axis, replicated leaves checked to be the same tensor on every rank."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: _regroup([s[k] for s in shards], spec[k]) for k in first}
    if isinstance(first, list):
        return [_regroup([s[i] for s in shards], spec[i]) for i in range(len(first))]
    if spec is None:
        assert all(s is first for s in shards)
        return first
    return torch.cat(shards, dim=spec)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("model, m", [("dev", 2), ("tiny", 2), ("tiny", 3), ("tiny", 6)])
def test_shards_concatenate_to_the_whole_tree(model, m, quantized):
    dims = MODEL_DIMS[model]
    params = _tree(model, quantized)
    spec = param_pspecs(dims)
    if quantized:
        spec = quantize_pspecs(spec, params)
    shards = [shard_params(params, _mesh(m, i), dims) for i in range(m)]
    whole = _regroup(shards, spec)
    for a, b in zip(leaves(whole), leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # Each rank holds n_head / m heads of q, and 1/m of fc2's rows.
    blk = shards[0]["encoder"]["blocks"][0]
    w = "w_q" if quantized else "w"
    assert blk["attn"]["q"][w].shape == (dims.n_audio_state, dims.n_audio_state // m)
    assert blk["mlp"]["fc2"][w].shape == (4 * dims.n_audio_state // m, dims.n_audio_state)
    assert all(t.is_contiguous() for t in leaves(shards[-1]))


def test_one_rank_holds_the_whole_tree():
    params = _tree("dev", False)
    out = shard_params(params, _mesh(1), MODEL_DIMS["dev"])
    assert all(a is b for a, b in zip(leaves(out), leaves(params)))


@pytest.mark.parametrize("model, m", [("dev", 4), ("tiny", 4), ("dev", 3)])
def test_a_degree_that_does_not_divide_the_heads_raises(model, m):
    with pytest.raises(ValueError, match=f"model-parallel degree {m} must divide heads"):
        shard_params(_tree(model, False), _mesh(m), MODEL_DIMS[model])


def test_quantise_then_shard_keeps_the_whole_scales():
    dims = MODEL_DIMS["tiny"]
    params = _tree("tiny", False)
    whole = quantize_params(params)
    m = 2
    shards = [shard_params(whole, _mesh(m, i), dims) for i in range(m)]
    for i, shard in enumerate(shards):
        for side in ("encoder", "decoder"):
            for blk, ref in zip(shard[side]["blocks"], whole[side]["blocks"]):
                # Row-parallel: the scale is the whole tree's, over all of d_in.
                assert torch.equal(blk["mlp"]["fc2"]["w_s"], ref["mlp"]["fc2"]["w_s"])
                assert torch.equal(blk["attn"]["o"]["w_s"], ref["attn"]["o"]["w_s"])
                # Column-parallel: this rank's slice of the whole scale.
                n = ref["attn"]["q"]["w_s"].shape[0] // m
                assert torch.equal(blk["attn"]["q"]["w_s"], ref["attn"]["q"]["w_s"][i * n : (i + 1) * n])
        assert torch.equal(shard["decoder"]["tok_emb"]["s"], whole["decoder"]["tok_emb"]["s"])
    # Scales taken per shard of a row-parallel weight would differ.
    w = params["decoder"]["blocks"][0]["mlp"]["fc2"]["w"]
    per_shard = absmax_quantize(w[: w.shape[0] // m], (0,))[1]
    assert not torch.equal(per_shard, whole["decoder"]["blocks"][0]["mlp"]["fc2"]["w_s"])


def test_mesh_model_coordinates_and_collectives_without_a_model_axis():
    mesh = _mesh(2, 1)
    assert (mesh.model_size, mesh.model_index, mesh.data_size) == (2, 1, 1)
    assert collectives.local_heads(6, mesh) == 3 and collectives.local_heads(6, None) == 6
    with pytest.raises(ValueError, match="must divide"):
        collectives.local_heads(3, mesh)
    collectives.reset()
    x = torch.arange(6.0).reshape(2, 3)
    for one in (None, _mesh(1)):
        assert collectives.all_reduce_model(x, one) is x
        assert collectives.all_gather_model(x, one) is x
    assert collectives.calls == 0 and collectives.by_stage == {}
