"""The (data, model) mesh of a multi-process run, as one rank sees it.

Counterpart of ``whisper_tpu/parallel/mesh.py``. There one program drives a
``jax.sharding.Mesh`` of devices. The port runs one process per rank under
``torch.distributed`` (``parallel/multihost.py``), so that each card gets
its own host thread for the eager decode loop; a mesh here is the grid's
shape plus this rank's place in it and its device. Ranks enumerate the grid
with ``model`` innermost, as JAX's device list does.

It is not built on ``torch.distributed.DeviceMesh``: its "cuda" device type
expects NCCL, which refuses two ranks on one card. The mesh builds its own
gloo sub-groups, once per shape: one model group per data index (the m
ranks that hold one model between them, ``parallel/collectives.py``) and
one data group per model index (the d ranks that split the batch, over
which ``multihost.allgather_rows`` gathers the results). Its collectives
run on the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

import torch.distributed as dist

from whisper_tpu_torch.parallel.multihost import rank, world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) grid of ranks."""

    shape: Dict[str, int]  # {"data": d, "model": m}, as JAX's Mesh.shape
    axis_names: Tuple[str, str]
    data_index: int  # this rank's index along the data axis
    device: torch.device  # the device this rank runs on
    model_index: int = 0  # this rank's index along the model axis
    model_group: Any = None  # gloo group of this rank's model peers (None: m == 1)
    data_group: Any = None  # gloo group of this rank's data peers (None: the world)

    @property
    def data_size(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def model_size(self) -> int:
        return self.shape[self.axis_names[1]]

    def local_rows(self, batch: np.ndarray) -> np.ndarray:
        """This rank's contiguous share of a batch every rank holds (its row
        count a multiple of the data size)."""
        per = batch.shape[0] // self.data_size
        return batch[self.data_index * per : (self.data_index + 1) * per]


def local_mesh_shape(
    n_devices: Optional[int] = None, model_parallel: Optional[int] = None
) -> Tuple[int, int]:
    """A (data, model) shape for ``n_devices`` ranks (default: the world
    size). The model-parallel degree defaults to 1."""
    n = n_devices or world_size()
    mp = model_parallel or 1
    if n % mp:
        raise ValueError(f"n_devices={n} not divisible by model_parallel={mp}")
    return (n // mp, mp)


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` when CUDA is
    asked for (so ranks share a card when there are fewer cards than ranks
    on the host), else ``device`` as it is. CUDA without a card raises
    ``RuntimeError``, as the engine's entry points do."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(
            "device='cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    local_rank = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local_rank % cards)


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """This rank's view of a 2-D (data, model) mesh over the world's ranks.
    The world must have exactly data · model ranks. Its device is this
    rank's card unless the caller asks for another (``device="cpu"``)."""
    if shape is None:
        shape = local_mesh_shape()
    d, m = (int(n) for n in shape)
    world = world_size()
    if d * m != world:
        raise ValueError(f"mesh {(d, m)} needs {d * m} processes, have {world}")
    model_group, data_group = _groups(d, m)
    return Mesh(
        shape={axis_names[0]: d, axis_names[1]: m},
        axis_names=tuple(axis_names),
        data_index=rank() // m,
        device=rank_device(device),
        model_index=rank() % m,
        model_group=model_group,
        data_group=data_group,
    )


_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def _groups(d: int, m: int) -> Tuple[Any, Any]:
    """This rank's (model group, data group) of a (d, m) world, built the
    first time a mesh of that shape is made. Every rank builds every group,
    in the same order, as ``new_group`` requires. Without a model axis the
    data group is the whole world (None)."""
    if m == 1:
        return None, None
    if (d, m) not in _GROUPS:
        me = rank()
        mine = [None, None]
        for i in range(d):  # model groups: one per data index
            g = dist.new_group([i * m + j for j in range(m)], backend="gloo")
            if me // m == i:
                mine[0] = g
        for j in range(m):  # data groups: one per model index
            g = dist.new_group([i * m + j for i in range(d)], backend="gloo")
            if me % m == j:
                mine[1] = g
        _GROUPS[(d, m)] = tuple(mine)
    return _GROUPS[(d, m)]
