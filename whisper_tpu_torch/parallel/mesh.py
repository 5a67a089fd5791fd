"""The (data, model) mesh of a multi-process run, as one rank sees it.

Counterpart of ``whisper_tpu/parallel/mesh.py``. There one program drives a
``jax.sharding.Mesh`` of devices. The port runs one process per rank under
``torch.distributed`` (``parallel/multihost.py``), so that each card gets
its own host thread for the eager decode loop; a mesh here is the grid's
shape plus this rank's place in it and its device. Ranks enumerate the grid
with ``model`` innermost, as JAX's device list does.

It is not built on ``torch.distributed.DeviceMesh``: its "cuda" device type
expects NCCL, which refuses two ranks on one card, and the data-parallel
path needs no sub-groups. Its collectives run on the host, over gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from whisper_tpu_torch.parallel.multihost import rank, world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) grid of ranks."""

    shape: Dict[str, int]  # {"data": d, "model": m}, as JAX's Mesh.shape
    axis_names: Tuple[str, str]
    data_index: int  # this rank's index along the data axis
    device: torch.device  # the device this rank runs on

    @property
    def data_size(self) -> int:
        return self.shape[self.axis_names[0]]

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
    on the host), else ``device`` as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    device: Union[str, torch.device] = "cpu",
) -> Mesh:
    """This rank's view of a 2-D (data, model) mesh over the world's ranks.
    The world must have exactly data · model ranks."""
    if shape is None:
        shape = local_mesh_shape()
    d, m = (int(n) for n in shape)
    world = world_size()
    if d * m != world:
        raise ValueError(f"mesh {(d, m)} needs {d * m} processes, have {world}")
    return Mesh(
        shape={axis_names[0]: d, axis_names[1]: m},
        axis_names=tuple(axis_names),
        data_index=rank() // m,
        device=rank_device(device),
    )
