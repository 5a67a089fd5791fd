"""Data- and tensor-parallel runs over ``torch.distributed``, one process
per rank.

Counterpart of ``whisper_tpu/parallel``: the (data, model) mesh
(``mesh.py``), the multi-process runtime (``multihost.py``), the Megatron
layout of the parameters (``sharding.py``), the collectives the layers
place themselves where JAX's GSPMD would (``collectives.py``), and the
dry run over mesh layouts (``dryrun.py``).
"""

from whisper_tpu_torch.parallel.mesh import Mesh, local_mesh_shape, make_mesh
from whisper_tpu_torch.parallel.multihost import (
    allgather_rows,
    host_shard,
    initialize,
    load_files_sharded,
    local_batch,
    uniform_host_rows,
)
from whisper_tpu_torch.parallel.sharding import (
    param_pspecs,
    shard_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "local_mesh_shape",
    "initialize",
    "host_shard",
    "uniform_host_rows",
    "local_batch",
    "load_files_sharded",
    "allgather_rows",
    "param_pspecs",
    "shard_params",
]
