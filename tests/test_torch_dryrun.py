"""The port's multi-rank dry run (``parallel/dryrun.dryrun_multichip``), the
counterpart of ``tests/test_sharding.py``'s: worlds of CPU ranks over gloo
on the meshes (2, 1) and (1, 2), every rank's tokens equal to one
process's. The ``dev`` leg (greedy and beam 2) runs here; the whole matrix
(``tiny``, the flagship's int8 + fp8 KV at beam 5, ``fused_step=True`` and
lineage, a speculative draft, ``transcribe_files``) runs under ``slow``, as
JAX's does.
"""

import pytest
import torch

from whisper_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_shapes

torch.set_num_threads(2)


def test_mesh_shapes():
    assert mesh_shapes(2) == [(2, 1), (1, 2)]
    assert mesh_shapes(4) == [(4, 1), (2, 2)]
    assert mesh_shapes(3) == [(3, 1)]


def test_dryrun_dev_leg():
    dryrun_multichip(2, dev_only=True, timeout=240)


@pytest.mark.slow
def test_dryrun_multichip_full():
    dryrun_multichip(2, timeout=600)
