"""A decode step captured once as a CUDA graph and replayed every step.

The greedy loop (``decode/greedy.py``, without temperature) and the beam
loop in its ``"hybrid"`` mode (``decode/beam.py``) spend most of a step's
time on the host, launching a few hundred to a few thousand small kernels.
Given a :class:`StepGraphs` (the engine passes one on CUDA without a mesh),
they run each step as one replay of a graph captured from the same step.

A graph fixes every address and shape, so such a step keeps its state in
static buffers (:meth:`StepGraphs.entry`, one set per buffer shape) and reads
its position from a one-element device tensor that the step advances
itself (the position-tensor forms of ``models/decoder.py``). Its
self-attention reads a fixed window of the cache under a mask: the
positions up to the next multiple of :data:`WINDOW` (:func:`window`), so a
step reads at most ``WINDOW - 1`` positions more than the eager loop's
window (the whole cache would double the attention's upcasts and reads
late in a 224-token decode). An entry runs its first :data:`WARM_STEPS`
steps eagerly with the same step function (they are steps of the real
decode, and let PyTorch and the math libraries set up their workspaces),
then captures one graph per variant of the step the first time it is
needed (the read window; beam: also the parity of the plane it reads),
all over one memory pool and one set of buffers, then replays. A capture
records the step without running it; the replay that follows runs it. On
the CPU nothing is captured: every step runs eagerly, so the step
functions can be tested there.

Entries whose buffers have the same shapes share them (``share``: the
rows, the cache length, the dtypes), and the cross-K/V is held at the
encoder's whole context (:func:`cross_buffers`), each crop a contiguous
view at its start (:func:`crop`): one decode at a time reads them, and
each decode writes what it reads before its first step. So the crops of
one batch shape, or the prompt lengths of one budget, cost graphs and no
more buffers; every capture of an engine draws on one memory pool.

The captured step opens no span and bumps no counter of its own: those
would run only once, at capture. The ``launches`` of the hand-written
kernels a captured step runs (K2, ``ops/fused_step``; the cross-attention,
``ops/cross_attend``; the routed experts, ``ops/moe_expert``) count what
the capture launched; that is taken back, and each replay adds it again,
so they keep counting launches on the card.
:data:`captures` and :data:`replays` count this module's work.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Tuple

import torch

from whisper_tpu_torch.ops import cross_attend, fused_step, moe_expert

WARM_STEPS = 2  # eager steps of an entry before its first capture
MAX_ENTRIES = 4  # shape keys an engine keeps captured
WINDOW = 32  # a captured step's read window grows in steps of this many positions
COUNTED = (fused_step, cross_attend, moe_expert)  # kernel modules whose ``launches`` replays add to

# Graphs captured and steps replayed in this process.
captures = 0
replays = 0


def window(pos: int, total: int) -> int:
    """The read window ``[0, w)`` of a captured step that writes position
    ``pos`` of a cache of ``total`` positions: ``pos`` rounded up past the
    next multiple of :data:`WINDOW`, at most ``total``."""
    return min(total, (pos // WINDOW + 1) * WINDOW)


class Entry:
    """One shape key's captured graphs over its (possibly shared) buffers."""

    def __init__(self, owner: "StepGraphs", share: Hashable, keep: tuple):
        self._owner = owner
        self.share = share
        self.buffers = owner._buffers[share]
        self._keep = keep  # what the captured steps read besides the buffers
        self._warm = 0
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, list]] = {}

    def step(self, run: Callable[[Hashable], None], variant: Hashable) -> bool:
        """One step: ``run(variant)`` eagerly while the entry warms up or
        on the CPU, else a replay of its graph for ``variant`` (captured
        first where there is none). Returns whether it replayed."""
        global replays
        if self._warm < WARM_STEPS or not self.buffers.pos.is_cuda:
            run(variant)
            self._warm += 1
            return False
        if variant not in self._graphs:
            self._capture(run, variant)
        graph, launched = self._graphs[variant]
        graph.replay()
        for mod, n in launched:
            mod.launches += n
        replays += 1
        return True

    def _capture(self, run: Callable[[Hashable], None], variant: Hashable) -> None:
        """Capture ``run(variant)`` on a side stream that first waits for
        the current one (``torch.cuda.graph``'s context would also drain
        the card and empty the allocator's cache before each of a decode's
        captures)."""
        global captures
        owner = self._owner
        if owner._pool is None:
            owner._pool = torch.cuda.graph_pool_handle()
        before = [mod.launches for mod in COUNTED]
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream(current.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # thread_local: a serving thread's CUDA work elsewhere in the
            # process does not break the capture.
            graph.capture_begin(pool=owner._pool, capture_error_mode="thread_local")
            try:
                run(variant)
            finally:
                graph.capture_end()
        current.wait_stream(side)
        launched = [(mod, mod.launches - b) for mod, b in zip(COUNTED, before)]
        for mod, b in zip(COUNTED, before):
            mod.launches = b
        self._graphs[variant] = (graph, [(mod, n) for mod, n in launched if n])
        captures += 1


class StepGraphs:
    """An engine's captured decode steps: at most ``size`` entries, the
    least recently used dropped first, and the buffers some entry uses.
    One decode at a time uses it."""

    def __init__(self, size: int = MAX_ENTRIES):
        self.size = size
        self._entries: "collections.OrderedDict[Hashable, Entry]" = collections.OrderedDict()
        self._buffers: Dict[Hashable, object] = {}
        self._pool = None  # every capture's memory pool

    def entry(
        self, key: Hashable, make: Callable[[], object], keep: tuple = (), share: Hashable = None
    ) -> Entry:
        """The entry of ``key``, over the buffers of ``share`` (``key``
        where None), made by ``make()`` (an object with at least a
        one-element int64 ``pos``) when no entry holds them. ``keep``:
        tensors and objects the step reads besides the buffers (weights,
        biases, rules), held as long as the entry, since a captured graph
        holds their addresses."""
        share = key if share is None else share
        entry = self._entries.pop(key, None)
        if entry is None:
            while len(self._entries) >= self.size:
                self._entries.popitem(last=False)
            used = {e.share for e in self._entries.values()}
            self._buffers = {s: b for s, b in self._buffers.items() if s in used}
            if share not in self._buffers:
                self._buffers[share] = make()
            entry = Entry(self, share, keep)
        self._entries[key] = entry
        return entry

    def __len__(self) -> int:
        return len(self._entries)


def cross_buffers(dims, rows: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed cross-K/V buffers [L, rows, H, Dh, n_audio_ctx], the
    encoder's whole context, for :func:`crop`."""
    h = dims.n_text_head
    shape = (dims.n_text_layer, rows, h, dims.n_text_state // h, dims.n_audio_ctx)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}


def crop(cross: Dict[str, torch.Tensor], ctx: int) -> Dict[str, torch.Tensor]:
    """Contiguous views [L, rows, H, Dh, ctx] at the start of
    :func:`cross_buffers`' storage: the same addresses for every decode
    at ``ctx``."""
    return {
        n: c.view(-1)[: c[..., :ctx].numel()].view(*c.shape[:-1], ctx) for n, c in cross.items()
    }
