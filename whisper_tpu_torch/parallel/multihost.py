"""Multi-process runtime: distributed init, per-rank batches and files, and
the gather of results.

Counterpart of ``whisper_tpu/parallel/multihost.py``. JAX runs one
controller per host over a global device mesh; the port runs one process
per rank under ``torch.distributed``, each decoding its contiguous share of
the batch:

* :func:`initialize`: a gloo process group (a no-op for one process and
  on a second call);
* :func:`host_shard` and :func:`uniform_host_rows`: which slice of a work
  list a rank owns, and the row count every rank pads to;
* :func:`local_batch` and :func:`load_files_sharded`: this rank's rows of
  the (never assembled) global batch, from its own files;
* :func:`allgather_rows`: every data rank's rows, in order, on every rank.

On a (data, model) mesh the m ranks of a model group hold the same rows, so
the work list is split, and the results gathered, along the data axis only:
a rank's share is that of its data index among ``world / m`` (the
:class:`~whisper_tpu_torch.parallel.mesh.Mesh` knows both). Every collective
runs on the host over gloo, on CPU tensors. Weights are built identically
on every rank (the same seed or the same file), so data parallelism needs
no collective on the device.

A rank reads its files with the native loader (``native/``) when it is
built and the files are plain WAVs, else with the Python readers.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from whisper_tpu_torch.audio.wav import read_wav


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a gloo process group at ``coordinator_address`` (``host:port``).
    Safe to call unconditionally: one process is a no-op, and so is a second
    call. Without an address, a launcher's environment (``torchrun``:
    ``WORLD_SIZE`` > 1, ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``) is
    used."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group("gloo", init_method="env://")
        return
    if num_processes in (None, 1):
        return
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    dist.init_process_group(
        "gloo", init_method=addr, world_size=num_processes, rank=process_id
    )


def data_processes(mesh=None) -> Tuple[int, int]:
    """(this process's index, the process count) along the data axis: the
    rank and the world without a mesh or a model axis, else the data index
    among ``world / m`` (the m ranks of a model group share one share)."""
    m = 1 if mesh is None else mesh.model_size
    return rank() // m, world_size() // m


def host_shard(
    n_items: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    mesh=None,
) -> Tuple[int, int]:
    """[start, end) of the work list owned by a process along the data axis
    (default: this one, see :func:`data_processes`): contiguous blocks in
    the order of the mesh's data axis."""
    pi, pc = data_processes(mesh)
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = -(-n_items // pc)  # ceil
    start = min(pi * per, n_items)
    return start, min(start + per, n_items)


def _local_shards(mesh) -> int:
    """Data shards per process: ``data // processes``, else ``data`` when
    the axis does not divide (1 with one process per rank)."""
    pc, axis = data_processes(mesh)[1], mesh.data_size
    return max(axis // pc if axis % pc == 0 else axis, 1)


def uniform_host_rows(n_items: int, mesh) -> int:
    """The padded row count every rank contributes for an n-item work list:
    the ceil share, rounded up to a multiple of the rank's local data shards,
    so that the global batch divides evenly however unevenly
    :func:`host_shard` splits the items."""
    per = -(-n_items // data_processes(mesh)[1])
    local = _local_shards(mesh)
    return -(-per // local) * local


def local_batch(local: np.ndarray, mesh, pad_to: Optional[int] = None) -> np.ndarray:
    """This rank's rows of the global batch: ``local`` zero-padded to
    ``pad_to`` rows (the uniform count of :func:`uniform_host_rows`), else
    to a multiple of the rank's local data shards. The counterpart of JAX's
    ``global_batch``, whose global array the port never assembles: rank r's
    rows are rows ``[r · n, (r + 1) · n)`` of it."""
    shards = _local_shards(mesh)
    n = local.shape[0]
    target = pad_to if pad_to is not None else -(-n // shards) * shards
    if n < target:
        pad = np.zeros((target - n, *local.shape[1:]), local.dtype)
        local = np.concatenate([local, pad], axis=0)
    return local


def read_files(
    paths: Sequence[str],
    max_len: int = 480_000,
    read: Callable[[str], np.ndarray] = read_wav,
    native: bool = True,
) -> np.ndarray:
    """``paths`` into [len(paths), max_len] float32 rows, zero-padded: with
    the native loader's ``load_batch`` where ``native`` allows it and the
    library is built (``native.load_native``), else, and wherever the native
    read refuses a file, one ``read`` per path. The native read equals
    ``audio.wav.read_wav`` bitwise; callers whose ``read`` differs from it
    (raw PCM, the reference's stereo quirk) pass ``native=False``."""
    from whisper_tpu_torch.native import load_native

    host = load_native() if native and len(paths) else None
    if host is not None:
        try:
            return host.load_batch(list(paths), max_len=max_len)
        except ValueError:
            pass  # a file the native read refuses: the Python readers decide
    rows = np.zeros((len(paths), max_len), np.float32)
    for i, p in enumerate(paths):
        s = read(p)
        n = min(len(s), max_len)
        rows[i, :n] = s[:n]
    return rows


def load_files_sharded(
    paths: Sequence[str],
    mesh,
    max_len: int = 480_000,
    read: Callable[[str], np.ndarray] = read_wav,
    native: bool = True,
) -> Tuple[np.ndarray, List[str]]:
    """This rank reads only its data share of ``paths`` (:func:`read_files`:
    the native loader, else ``read``, the WAV reader by default) into
    [uniform rows, max_len] float32 rows, zero-padded. Returns (rows, this
    rank's paths)."""
    start, end = host_shard(len(paths), mesh=mesh)
    local_paths = list(paths[start:end])
    rows = read_files(local_paths, max_len, read, native)
    return local_batch(rows, mesh, pad_to=uniform_host_rows(len(paths), mesh)), local_paths


def allgather_rows(x: np.ndarray, mesh=None) -> np.ndarray:
    """Every data rank's rows concatenated in data order, on every rank: the
    counterpart of ``process_allgather(tiled=True)``. gloo's ``all_gather``
    on CPU tensors over the mesh's data group (the world without a model
    axis); every rank passes the same shape and dtype."""
    group = None if mesh is None else mesh.data_group
    pc = world_size() if group is None else dist.get_world_size(group)
    if pc == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(pc)]
    dist.all_gather(out, t, group=group)
    return torch.cat(out).numpy()
