"""Data-parallel runs over ``torch.distributed``, one process per rank.

Counterpart of ``whisper_tpu/parallel``, without its tensor-parallel names
(``param_pspecs``, ``shard_params``, ``input_pspec``, ``enc_out_pspec``):
tensor parallelism is not ported yet.
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
]
