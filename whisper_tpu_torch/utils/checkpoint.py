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
import struct
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models.params import Params, _tensor_from_numpy
from whisper_tpu_torch.models.quantize import (
    absmax_quantize,
    is_quantized,
    quantize_params,
    quantize_pspecs,
)
from whisper_tpu_torch.parallel.sharding import cut, param_pspecs

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


def save_params(path: str, params: Params, dims: ModelDims) -> None:
    """Write port ``params`` and ``dims`` as the JAX package's npz."""
    flat = _flatten(_to_jax_layout(params))
    flat["__dims__"] = np.frombuffer(json.dumps(dataclasses.asdict(dims)).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_params(
    path: str, mesh=None, quantization: Optional[str] = None
) -> Tuple[Params, ModelDims]:
    """Read an npz written by either package → (port params on the CPU,
    dims), one member at a time. A stored member (``np.savez`` stores them
    uncompressed) is mapped from the file at its offset (:class:`_Member`),
    so the host holds what is built so far and the leaf being read, never
    the file's arrays besides. A compressed member
    (``np.savez_compressed``) cannot be mapped: it is read whole, one at a
    time.

    ``mesh`` with a model axis > 1 (a ``parallel.mesh.Mesh``, or anything
    with its ``model_index`` and ``model_size``): the counterpart of JAX's
    ``load_params_orbax(path, mesh)``. Only this rank's slice of every leaf
    is read and returned, cut on the axis of ``parallel.sharding``'s
    ``param_pspecs`` (``quantize_pspecs`` for an int8 tree) by the same
    ``cut`` as ``shard_params``, so it equals ``shard_params`` of the whole
    tree bit for bit. Build the rank's engine on it with ``shard=(
    mesh.model_index, mesh.model_size)`` (``create_engine``), which then
    moves only the slice to its device.

    ``quantization="int8"`` on a float file gives the tree
    ``quantize_params`` gives (then cut). A weight cut across its scale's
    span (a row-parallel weight's scale runs over the whole d_in, the
    embedding's over a whole row) is read whole along that span, in blocks
    of output channels, quantised and cut; a weight cut along its output
    channels, or replicated, is read as its slice and quantised. An int8
    file is read in slices only."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the JAX package's Orbax checkpoints need "
            "Orbax and JAX, which whisper_tpu_torch does not use; convert it "
            "to an npz with whisper_tpu (utils/checkpoint.save_params)"
        )
    if quantization not in (None, "int8"):
        raise ValueError(f"unknown quantization: {quantization!r}")
    members = _members(path)
    dims = ModelDims(**json.loads(bytes(members.pop("__dims__").array()).decode()))
    m, i = (mesh.model_size, mesh.model_index) if mesh is not None else (1, 0)
    meta = _meta_tree(members)
    quantize = quantization == "int8" and not is_quantized(meta)
    specs = None
    if m > 1:
        target = quantize_params(meta) if quantize else meta
        specs = param_pspecs(dims)
        if is_quantized(target):
            specs = quantize_pspecs(specs, target)

    def spec(port_path):
        node = specs
        for part in port_path:
            if node is None:
                return None
            node = node[part]
        return node

    params: dict = {}
    for key, member in members.items():
        arr = member.array()
        for port_path, view in _port_views(key, arr):
            emb = port_path == ("decoder", "tok_emb")
            if quantize and (emb or port_path[-1] == "w"):
                # {"w"} → {"w_q", "w_s"} in its dict; the table → {"q", "s"}
                parent, (qn, sn) = (port_path, ("q", "s")) if emb else (port_path[:-1], ("w_q", "w_s"))
                q, s = _quantize_cut(view, emb, spec(parent + (qn,)), m, i)
                _put(params, parent + (qn,), q)
                _put(params, parent + (sn,), s)
            else:
                x = cut(view, spec(port_path), m, i)
                _put(params, port_path, _tensor_from_numpy(x, copy=False))
        del arr  # a compressed member's whole array goes here
    return params, dims


# A block of output channels read whole along its scale's span while a
# float file is quantised (about 16 MiB of f32).
_BLOCK_ELEMENTS = 1 << 22


def _quantize_cut(view: np.ndarray, emb: bool, axis, m: int, i: int):
    """Quantise one float weight (port layout) as ``quantize_params`` does,
    and cut it on ``axis``: → (q, scale) of this rank. ``emb``: the token
    table [V, d], scaled per row; else a linear [d_in, d_out] or a conv
    [c_out, c_in, width] weight, scaled per output channel."""
    out_axis = 0 if emb or view.ndim == 3 else 1
    reduce_dims = (1,) if emb else (0,) if view.ndim == 2 else (1, 2)
    if axis is None or axis == out_axis or m == 1:
        w = _tensor_from_numpy(cut(view, axis, m, i), copy=False)
        return absmax_quantize(w, reduce_dims)
    n = view.shape[out_axis]
    per = max(1, _BLOCK_ELEMENTS * n // max(view.size, 1))
    qs, ss = [], []
    for c0 in range(0, n, per):
        index = [slice(None)] * view.ndim
        index[out_axis] = slice(c0, c0 + per)
        w = _tensor_from_numpy(np.array(view[tuple(index)]), copy=False)
        q, s = absmax_quantize(w, reduce_dims)
        qs.append(cut(q, axis, m, i))
        ss.append(s)
    return torch.cat(qs, out_axis), torch.cat(ss)


class _Member:
    """One array of an npz file: its ``.npy`` header, and its bytes mapped
    from the file at their offset (a stored member) or read whole (a
    compressed one)."""

    def __init__(self, path: str, info: zipfile.ZipInfo):
        self.path, self.info = path, info
        self.stored = info.compress_type == zipfile.ZIP_STORED
        if self.stored:
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                local = f.read(_LOCAL_HEADER)
                if local[:4] != b"PK\x03\x04":
                    raise ValueError(f"{path}: no zip local header for {info.filename}")
                name_len, extra_len = struct.unpack("<HH", local[26:30])
                f.seek(info.header_offset + _LOCAL_HEADER + name_len + extra_len)
                self._read_header(f)
                self.offset = f.tell()
        else:
            with zipfile.ZipFile(path) as zf, zf.open(info) as f:
                self._read_header(f)

    def _read_header(self, f) -> None:
        version = np.lib.format.read_magic(f)
        read = (
            np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0
        )
        self.shape, self.fortran, self.dtype = read(f)

    def array(self) -> np.ndarray:
        """The whole array: an ``np.memmap`` that reads the file only where
        it is indexed (stored), or the array in memory (compressed)."""
        if not self.stored:
            with zipfile.ZipFile(self.path) as zf, zf.open(self.info) as f:
                return np.lib.format.read_array(f)
        return np.memmap(
            self.path, dtype=self.dtype, mode="r", offset=self.offset, shape=self.shape,
            order="F" if self.fortran else "C",
        )


_LOCAL_HEADER = 30  # the fixed part of a zip local file header


def _members(path: str) -> Dict[str, _Member]:
    """The npz's arrays by key (the member's name less ``.npy``), in the
    file's order."""
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    return {
        info.filename[: -len(".npy")]: _Member(path, info)
        for info in infos if info.filename.endswith(".npy")
    }


def _port_views(key: str, arr: np.ndarray):
    """(port path, view) of a member in the port's layout, by the rule of
    ``params_from_jax``: a stacked block leaf [L, ...] gives one view per
    layer (the layer index in the path), a conv weight HIO → ``[c_out,
    c_in, width]``, anything else itself. Views read nothing."""
    parts = tuple(key.split(_SEP))
    if len(parts) > 2 and parts[1] == "blocks":
        for layer in range(arr.shape[0]):
            yield parts[:2] + (layer,) + parts[2:], arr[layer]
    elif len(parts) > 1 and parts[-2] in _CONV and parts[-1] in ("w", "w_q"):
        yield parts, np.transpose(arr, (2, 1, 0))
    else:
        yield parts, arr


def _meta_tree(members: Dict[str, _Member]) -> Params:
    """The port tree of the file's shapes and dtypes as meta tensors (no
    memory, no read): what the specs of ``parallel/sharding.py`` and
    ``quantize_pspecs`` walk."""
    tree: dict = {}
    for key, member in members.items():
        dtype = _tensor_from_numpy(np.zeros(0, member.dtype)).dtype
        shaped = np.lib.stride_tricks.as_strided(
            np.zeros(1, member.dtype), shape=member.shape, strides=(0,) * len(member.shape)
        )
        for port_path, view in _port_views(key, shaped):
            _put(tree, port_path, torch.empty(view.shape, dtype=dtype, device="meta"))
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    """``tree[path] = value``, making the dicts on the way; an int in the
    path indexes a list of per-layer dicts (``blocks``)."""
    node = tree
    for part, nxt in zip(path[:-1], path[1:]):
        if isinstance(part, int):
            node.extend({} for _ in range(part + 1 - len(node)))
            node = node[part]
        else:
            node = node.setdefault(part, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value
