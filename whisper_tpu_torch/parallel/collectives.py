"""The collectives of tensor parallelism, all in one place.

JAX shards the parameters with annotations and lets GSPMD insert the
collectives (``whisper_tpu/parallel/sharding.py``). The port runs one
process per rank, so the layers call these functions where GSPMD would
place its collectives:

* :func:`all_reduce_model`: the sum of a row-parallel product's f32 partial
  results over the model group (the o projections, fc2, the logits);
* :func:`all_gather_model`: the feature slices of the token embedding.

Each takes the rank's :class:`~whisper_tpu_torch.parallel.mesh.Mesh` (or
None) and is a no-op where the model axis is 1. Both run over gloo on the
host: a CUDA tensor is staged through host memory explicitly (device →
host, the collective, host → device), so what a collective costs is
visible. NCCL refuses two ranks on one card, and one card is what the port
has been run on.

Counts, read by tests and ``chip_smoke.py`` as the kernels' ``launches``
are: :data:`calls` (every collective of this process), :data:`by_stage`
(the same, by the outermost :func:`stage` open at the call: "encode",
"detect", "prefill", "step", "window", "align"; each stage is also a
span of ``utils/profiling``) and :data:`host_seconds`
(wall time from the staging copy out to the copy back, with the card's
queue drained before the clock starts, so the work queued before the
collective is not charged to it).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from whisper_tpu_torch.utils.profiling import annotate

calls = 0
by_stage: Dict[str, int] = {}
host_seconds = 0.0
_stage: Optional[str] = None


def reset() -> None:
    """Set every count to 0."""
    global calls, host_seconds
    calls, host_seconds = 0, 0.0
    by_stage.clear()


@contextlib.contextmanager
def stage(name: str):
    """Count the collectives made while the ``with`` lasts under ``name``,
    unless an outer stage is open (language detection runs a prefill: its
    collectives count as "detect"). While spans are recorded, the stage is
    also a span named ``name`` (``utils/profiling.annotate``), inner stages
    included."""
    global _stage
    outer = _stage
    if outer is None:
        _stage = name
    try:
        with annotate(name):
            yield
    finally:
        _stage = outer


def model_size(mesh) -> int:
    """The model axis of ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.model_size


def local_heads(n_head: int, mesh) -> int:
    """The heads this rank holds: ``n_head / m``. The head width stays that
    of the whole model."""
    m = model_size(mesh)
    if n_head % m:
        raise ValueError(f"model-parallel degree {m} must divide the {n_head} heads")
    return n_head // m


def _count(t0: float) -> None:
    global calls, host_seconds
    calls += 1
    host_seconds += time.perf_counter() - t0
    if _stage is not None:
        by_stage[_stage] = by_stage.get(_stage, 0) + 1


def _to_host(x: torch.Tensor) -> tuple:
    """(a contiguous CPU copy of ``x``, the clock's start)."""
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        return x.detach().to("cpu").contiguous(), t0
    return x.detach().contiguous().clone(), time.perf_counter()


def all_reduce_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over this rank's model group, as a new tensor on
    ``x``'s device (``x`` itself unchanged). Every rank of the group gets
    the same bytes."""
    if model_size(mesh) == 1:
        return x
    host, t0 = _to_host(x)
    dist.all_reduce(host, group=mesh.model_group)
    out = host.to(x.device)
    _count(t0)
    return out


def all_gather_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The model group's tensors concatenated along ``dim`` in model-index
    order, on ``x``'s device. Every rank passes the same shape."""
    m = model_size(mesh)
    if m == 1:
        return x
    host, t0 = _to_host(x)
    parts = [torch.empty_like(host) for _ in range(m)]
    dist.all_gather(parts, host, group=mesh.model_group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _count(t0)
    return out
