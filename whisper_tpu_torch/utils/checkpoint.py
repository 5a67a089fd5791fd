"""Converted-checkpoint files: a flat-key npz with a dims header.

Counterpart of ``whisper_tpu/utils/checkpoint.py`` (``save_params``,
``load_params``), in the same file format, so each package reads the
other's files. The npz holds the JAX layout: keys are tree paths joined by
"/", transformer blocks are stacked along a leading layer axis, conv
weights are HIO ``[width, c_in, c_out]``, and ``__dims__`` holds the
``ModelDims`` as JSON bytes. The port converts to and from its own layout
(a per-layer ``blocks`` list, conv weights ``[c_out, c_in, width]``) by
the rule of ``models.params.params_from_jax``; int8 trees convert the same
way. bf16 leaves are stored as numpy's opaque 2-byte type (``<V2``), as
JAX's ``ml_dtypes`` arrays land in an npz.

The JAX package's Orbax directories (sharded, multi-host) need Orbax and
JAX; the port refuses them with a message.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models.params import Params, params_from_jax

_SEP = "/"
_CONV = ("conv1", "conv2")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _to_jax_layout(params: Params) -> Dict:
    """Port parameters → the JAX pytree layout as nested dicts of numpy
    arrays: blocks stacked, conv weights HIO."""

    def convert(sub: dict) -> dict:
        out = {}
        for key, val in sub.items():
            if key == "blocks":
                layers = [convert(b) for b in val]
                out[key] = _stack(layers)
            elif key in _CONV:
                out[key] = {
                    k: np.transpose(_to_numpy(v), (2, 1, 0)) if k in ("w", "w_q") else _to_numpy(v)
                    for k, v in val.items()
                }
            elif isinstance(val, dict):
                out[key] = convert(val)
            else:
                out[key] = _to_numpy(val)
        return out

    return convert(params)


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parts, last = key.split(_SEP)
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def save_params(path: str, params: Params, dims: ModelDims) -> None:
    """Write port ``params`` and ``dims`` as the JAX package's npz."""
    flat = _flatten(_to_jax_layout(params))
    flat["__dims__"] = np.frombuffer(json.dumps(dataclasses.asdict(dims)).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_params(path: str) -> Tuple[Params, ModelDims]:
    """Read an npz written by either package → (port params on the CPU,
    dims)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the JAX package's Orbax checkpoints need "
            "Orbax and JAX, which whisper_tpu_torch does not use; convert it "
            "to an npz with whisper_tpu (utils/checkpoint.save_params)"
        )
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    dims = ModelDims(**json.loads(bytes(flat.pop("__dims__")).decode()))
    return params_from_jax(_unflatten(flat)), dims
