"""How parameters and activations lay out over the (data, model) mesh.

Counterpart of ``whisper_tpu/parallel/sharding.py``: Megatron tensor
parallelism with JAX's layout, without its mechanism. JAX writes the layout
as ``PartitionSpec`` annotations and GSPMD inserts the collectives; the
port runs one process per rank, so each rank holds only its slice of every
sharded weight (:func:`shard_params`) and the layers place the collectives
themselves (``parallel/collectives.py``, called from ``models/layers.py``):

* attention q, k, v and MLP fc1 are column-parallel: ``w`` [d_in, d_out]
  and ``b`` [d_out] are cut on d_out, so a rank holds ``n_head / m`` whole
  heads (the head width stays the model's);
* o and fc2 are row-parallel: ``w`` is cut on d_in and ``b`` replicated,
  and the f32 partial products are all-reduced before the bias;
* ``tok_emb`` [V, d] is cut on its feature axis: the embedding gathers its
  feature slices, and the logits contract over them and all-reduce;
* convolutions, layer norms and ``pos_emb`` are replicated.

The batch lies on ``data``: ``parallel/multihost.py`` cuts and gathers it
by the data index and the data size.

A spec leaf here is the axis of the port's tensor that the model axis cuts,
or None where the tensor is replicated. The port's blocks are a per-layer
list, so a block leaf's axis is JAX's less one (JAX stacks the layers on a
leading axis).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models.params import Params

REPLICATED = None
COLUMN = {"w": 1, "b": 0}  # [d_in, d_out] cut on d_out; b [d_out] with it
ROW = {"w": 0, "b": REPLICATED}  # cut on d_in (the contraction); b whole


def _ln() -> Dict[str, Optional[int]]:
    return {"g": REPLICATED, "b": REPLICATED}


def _attn() -> Dict[str, Any]:
    return {"q": dict(COLUMN), "k": {"w": 1}, "v": dict(COLUMN), "o": dict(ROW)}


def _mlp() -> Dict[str, Any]:
    return {"fc1": dict(COLUMN), "fc2": dict(ROW)}


def param_pspecs(dims: ModelDims) -> Dict[str, Any]:
    """The axis each leaf is cut on, in a tree congruent with
    ``models.params.init_params``' (blocks as per-layer lists)."""
    conv = {"w": REPLICATED, "b": REPLICATED}
    return {
        "encoder": {
            "conv1": conv,
            "conv2": dict(conv),
            "blocks": [
                {"ln1": _ln(), "attn": _attn(), "ln2": _ln(), "mlp": _mlp()}
                for _ in range(dims.n_audio_layer)
            ],
            "ln_post": _ln(),
        },
        "decoder": {
            "tok_emb": 1,  # feature axis: a local gather, a contraction that all-reduces
            "pos_emb": REPLICATED,
            "blocks": [
                {
                    "ln1": _ln(), "attn": _attn(), "ln2": _ln(),
                    "cross": _attn(), "ln3": _ln(), "mlp": _mlp(),
                }
                for _ in range(dims.n_text_layer)
            ],
            "ln": _ln(),
        },
    }


def shard_params(params: Params, mesh, dims: ModelDims) -> Params:
    """This rank's slice of a host-replicated tree (float or int8) per
    :func:`param_pspecs`: the counterpart of JAX's ``put_with_sharding``,
    whose ``make_array_from_callback`` cuts each device's shard from the
    full copy that every process holds. Cut slices are copies of their
    own, so the whole tree can be freed; replicated leaves are shared.
    The model-parallel degree must divide both head counts.

    An int8 tree must be quantised whole before it is cut
    (``models.quantize.quantize_pspecs``): a row-parallel weight's scale
    runs over the whole of d_in."""
    m, i = mesh.model_size, mesh.model_index
    if dims.n_audio_head % m or dims.n_text_head % m:
        raise ValueError(
            f"model-parallel degree {m} must divide heads "
            f"({dims.n_audio_head}/{dims.n_text_head})"
        )
    specs = param_pspecs(dims)
    from whisper_tpu_torch.models.quantize import is_quantized, quantize_pspecs

    if is_quantized(params):
        specs = quantize_pspecs(specs, params)
    return _cut(params, specs, m, i)


def _cut(node, spec, m: int, i: int):
    if isinstance(node, dict):
        return {k: _cut(v, spec[k], m, i) for k, v in node.items()}
    if isinstance(node, list):
        return [_cut(v, s, m, i) for v, s in zip(node, spec)]
    return cut(node, spec, m, i)


def cut(x, axis: Optional[int], m: int, i: int):
    """Slice ``i`` of ``m`` of one leaf on ``axis`` (None: replicated), the
    one rule of :func:`shard_params` and of the rank-sliced restore
    (``utils/checkpoint.load_params`` with a mesh). A torch tensor's slice
    is a contiguous copy of its own, and a replicated tensor is returned
    as it is. A numpy array (an ``np.memmap`` of a file member included)
    always comes back as an array in memory: the slice alone, read from
    the file only where it lies."""
    if isinstance(x, np.ndarray):
        if axis is not REPLICATED and m > 1:
            size = x.shape[axis] // m
            index = [slice(None)] * x.ndim
            index[axis] = slice(i * size, (i + 1) * size)
            x = x[tuple(index)]
        return np.array(x)
    if axis is REPLICATED or m == 1:
        return x
    size = x.shape[axis] // m
    return x.narrow(axis, i * size, size).clone(memory_format=torch.contiguous_format)
