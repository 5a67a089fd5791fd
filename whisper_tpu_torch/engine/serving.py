"""Async serving: request queue → micro-batcher → device executor, the
slot pool (continuous and disaggregated), and streaming sessions.

Counterpart of ``whisper_tpu/engine/serving.py``, with the same classes,
arguments and scheduling:

* :class:`AsyncTranscriber` coalesces concurrent requests into one
  ``transcribe_batch`` of ``max_batch`` rows, grouped by the
  ``audio_ctx="auto"`` crop their content resolves to, with the flush
  deadline anchored to the oldest pending arrival;
* :class:`ContinuousTranscriber` keeps a pool of decode slots
  (``decode/continuous.py``) advancing every macro-step, harvesting and
  refilling slots as utterances finish; :class:`DisaggregatedTranscriber`
  runs the prefill on its own thread (and, optionally, device);
* :class:`StreamingSession` is the mic pipeline: buffers in, utterances
  cut at 30 s or at a VAD silence, results out through a callback.

Where the JAX slot pool runs up to ``sync_every`` steps in one compiled
``while_loop`` that exits on the device once every slot is inactive, the
port enqueues the ``sync_every`` steps from the host with no read of the
device between them (finished slots are frozen by the active mask, so the
tokens are the same), and counts one dispatch per macro-step as JAX does.
The harvest reads a snapshot of ``active`` and ``tokens`` taken before
each dispatch, copied to pinned host memory behind a CUDA event: the host
waits for that copy only, one macro-step late, never for the step it has
just enqueued.

Threads share the card's default stream, so the disaggregated encode and
decode threads need no cross-stream synchronisation: a pack is enqueued
before the decode thread can see it. The listener callbacks mirror the
reference's status strings; the future-based API is the Python surface.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from whisper_tpu_torch.audio.vad import energy_vad
from whisper_tpu_torch.config import N_SAMPLES
from whisper_tpu_torch.decode import continuous as cont
from whisper_tpu_torch.engine.engine import (
    _SAMPLES_PER_POS,
    AUDIO_CTX_BUCKETS,
    AUDIO_CTX_MARGIN,
    Engine,
    TranscriptionResult,
    last_content_index,
    resolve_device,
    snap_audio_ctx,
)
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram
from whisper_tpu_torch.models.encoder import encode
from whisper_tpu_torch.models.params import to_device

# Status strings kept from the reference (Whisper.java:12-14).
MSG_PROCESSING = "Processing..."
MSG_DONE = "Processing done...!"


def refuse_tensor_parallel(engine: Engine, name: str) -> None:
    """Serving runs on one rank: an engine on a mesh with a model axis > 1
    (whose ranks must call every forward together) raises
    ``NotImplementedError`` naming ``name``. JAX's serving classes do not
    run on a mesh either."""
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.model_size > 1:
        raise NotImplementedError(
            f"{name} does not run on a tensor-parallel mesh (mesh_shape="
            f"{tuple(engine.config.mesh_shape)}): its requests arrive on one rank"
        )


@dataclass
class _Request:
    samples: np.ndarray
    future: Future


class AsyncTranscriber:
    """Micro-batching async front-end over an Engine.

    Requests submitted from any thread are coalesced for up to
    ``max_wait_ms`` or until ``max_batch`` requests of one crop bucket are
    pending, then run as one ``transcribe_batch``. Every flush is padded to
    the full ``max_batch`` rows (zero rows for missing requests), so the
    engine sees one batch shape per crop bucket whatever the arrival
    pattern. Pick ``max_batch`` for the steady-state load: zero rows burn
    device time.
    """

    def __init__(
        self,
        engine: Engine,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        on_status: Optional[Callable[[str], None]] = None,
    ):
        refuse_tensor_parallel(engine, type(self).__name__)
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.on_status = on_status
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._closed = False
        self._thread.start()

    # --- public API --------------------------------------------------------
    def submit(self, samples: np.ndarray) -> Future:
        """Enqueue an utterance; resolves to a TranscriptionResult."""
        if self._closed:
            raise RuntimeError("transcriber is closed")
        fut: Future = Future()
        self._queue.put(_Request(np.asarray(samples, np.float32), fut))
        return fut

    def transcribe(self, samples: np.ndarray) -> TranscriptionResult:
        return self.submit(samples).result()

    def close(self, wait: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            if wait:
                self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- worker ------------------------------------------------------------
    def warmup(self) -> None:
        """Run the flush shape once for every ``audio_ctx`` crop bucket, so
        that the first live request of each length class does not pay for
        the kernels' build, the allocator's first blocks and the math
        libraries' set-up."""
        if self.engine.config.audio_ctx == "auto":
            lens = [
                (b - AUDIO_CTX_MARGIN - 1) * _SAMPLES_PER_POS
                for b in AUDIO_CTX_BUCKETS
            ] + [N_SAMPLES]
        else:
            lens = [N_SAMPLES]
        for n in lens:
            x = np.zeros((self.max_batch, min(n, N_SAMPLES)), np.float32)
            x[:, -1] = 1e-4  # content through the last sample pins the bucket
            self.engine.transcribe_batch(x)

    def _bucket_of(self, samples: np.ndarray) -> int:
        """Length-aware admission key: utterances whose ``audio_ctx`` crop
        resolves identically batch together, so the "auto" crop applies
        under mixed-length load. Keyed on measured content (the last
        non-zero sample, the scan the engine resolves the crop from), not on
        buffer length. Constant (one group, FIFO) unless the engine runs
        ``audio_ctx="auto"``."""
        if self.engine.config.audio_ctx != "auto":
            return 0
        last = last_content_index(samples[None, :N_SAMPLES])
        return snap_audio_ctx(last, self.engine.dims.n_audio_ctx) or 0

    def _flush_group(
        self, pending: List[tuple], bucket: Optional[int] = None
    ) -> List[tuple]:
        """Flush up to max_batch pending ``(arrival_ts, bucket, request)``
        entries of one bucket — the given one, else the OLDEST entry's.
        Returns the rest."""
        b0 = pending[0][1] if bucket is None else bucket
        take: List[_Request] = []
        keep: List[tuple] = []
        for entry in pending:
            if len(take) < self.max_batch and entry[1] == b0:
                take.append(entry[2])
            else:
                keep.append(entry)
        self._flush(take)
        return keep

    def _worker(self) -> None:
        # Entries are (arrival_ts, bucket, request) in arrival order. The
        # flush deadline is anchored to the OLDEST pending arrival, not
        # reset per loop iteration, so a minority-bucket request's wait is
        # bounded by max_wait even under a stream that keeps filling other
        # buckets.
        pending: List[tuple] = []

        def admit(req):
            pending.append((time.monotonic(), self._bucket_of(req.samples), req))

        while True:
            if not pending:
                req = self._queue.get()
                if req is None:
                    return
                admit(req)
            full_bucket = None
            while True:
                head_deadline = pending[0][0] + self.max_wait_s
                counts: dict = {}
                for _, b, _r in pending:
                    counts[b] = counts.get(b, 0) + 1
                full_bucket = next(
                    (b for b, c in counts.items() if c >= self.max_batch), None
                )
                if full_bucket is not None:
                    break
                timeout = head_deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    while pending:
                        pending = self._flush_group(pending)
                    return
                admit(nxt)
            if full_bucket is not None and pending[0][0] + self.max_wait_s <= time.monotonic():
                # The head's wait expired while another bucket filled: serve
                # the head's bucket first, then the full one on the next
                # iteration (still pending and still full).
                full_bucket = None
            # A FULL bucket flushes as a whole batch; deadline expiry flushes
            # the head's bucket, FIFO-fair with a max_wait-bounded wait.
            pending = self._flush_group(pending, full_bucket)

    def _flush(self, batch: List[_Request]) -> None:
        if self.on_status:
            self.on_status(MSG_PROCESSING)
        # Always dispatch at the full max_batch rows (zero rows for missing
        # requests; their results are dropped below).
        stacked = np.zeros((self.max_batch, N_SAMPLES), dtype=np.float32)
        for i, r in enumerate(batch):
            n = min(len(r.samples), N_SAMPLES)
            stacked[i, :n] = r.samples[:n]
        try:
            # Per-batch error isolation: a bad batch fails its own futures,
            # the serving loop survives.
            results = self.engine.transcribe_batch(stacked)
            for r, res in zip(batch, results):
                r.future.set_result(res)
        except Exception as e:  # noqa: BLE001
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        if self.on_status:
            self.on_status(MSG_DONE)


def _canonical(device) -> torch.device:
    """``device`` with its CUDA index filled in, so that "cuda" and
    "cuda:0" compare equal."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _ContinuousBase:
    """Shared machinery of slot-pool serving (``decode/continuous.py``):
    prefill, macro-step, insert and move, slot bookkeeping, harvest."""

    def __init__(
        self,
        engine: Engine,
        n_slots: int = 8,
        prefill_batch: int = 2,
        sync_every: int = 4,  # decode steps per host dispatch (the slot
        # pool's macro-step), JAX's default
        omit_special_tokens: bool = True,
        encode_device=None,  # prefill's device: the engine's when None
        slot_buckets: Optional[List[int]] = None,
    ):
        refuse_tensor_parallel(engine, type(self).__name__)
        if engine.config.beam_size > 1:
            raise ValueError("continuous batching is greedy-only")
        self.engine = engine
        self.n_slots = n_slots
        self.prefill_batch = prefill_batch
        self.sync_every = max(1, sync_every)
        self.omit_special_tokens = omit_special_tokens
        self._device = _canonical(engine.device)
        # Encoder-side weights: a replica on the encode device when the
        # prefill runs on another device than the decode, else the engine's.
        self._encode_device = self._device if encode_device is None else _canonical(encode_device)
        if self._encode_device != self._device:
            self._encode_params = to_device(engine.assets.params, self._encode_device)
            self._encode_filters = engine._filters.to(self._encode_device)
            self._encode_bias = (
                None if engine._logit_bias is None else engine._logit_bias.to(self._encode_device)
            )
        else:
            self._encode_params = engine.assets.params
            self._encode_filters = engine._filters
            self._encode_bias = engine._logit_bias

        self._eot = engine.vocab.specials.eot
        self._p_len = int(engine._prompt.shape[0])
        self._total_len = self._p_len + engine._max_new
        # The pool's geometry is fixed at creation and it admits utterances
        # one by one, so there is no batch content to derive a crop from:
        # audio_ctx="auto" is the full window here; an int applies to every
        # slot.
        ac = engine.config.audio_ctx
        self._slot_ac = ac if isinstance(ac, int) and ac < engine.dims.n_audio_ctx else None

        # Occupancy buckets: a macro-step runs on the prefix sub-pool of the
        # smallest bucket covering the occupied slots, so a mostly-empty
        # pool does not stream every empty slot's KV each step. Occupied
        # slots are compacted into the prefix with move_slot.
        # ``slot_buckets=[n_slots]`` disables; the default is descending
        # powers of two down to max(2, prefill_batch).
        if slot_buckets is None:
            slot_buckets, b = [], n_slots
            while b >= max(2, min(prefill_batch, n_slots)):
                slot_buckets.append(b)
                b //= 2
        buckets = sorted(set(int(b) for b in slot_buckets) | {n_slots})
        if buckets[0] < 1 or buckets[-1] > n_slots:
            raise ValueError(f"slot_buckets out of range: {buckets}")
        self._buckets = buckets

        self._state = cont.init_slot_state(
            engine.dims, n_slots, self._total_len, self._eot,
            cache_dtype=engine._compute_dtype, kv_dtype=engine._kv_dtype,
            audio_ctx=self._slot_ac, device=self._device,
        )
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._slot_futures: List[Optional[Future]] = [None] * n_slots
        self._closed = False
        # Harvest source: a host snapshot of (active, tokens) taken just
        # before each macro-step dispatch (_dispatch_step), read one
        # macro-step later by _harvest.
        self._pending_harvest = None
        # Occupancy accounting (host side, macro-step granularity). Each
        # macro-step dispatches ``bucket`` slots, not the full pool.
        self._step_dispatches = 0
        self._occupied_slot_steps = 0
        self._dispatched_slot_steps = 0
        self._prefill_dispatches = 0

    # --- device work -------------------------------------------------------
    def _prefill(self, samples: np.ndarray) -> cont.SlotPack:
        """mel → encoder (K1 on the card) → prompts (language detection) →
        cross-KV + prompt prefill + first token, on the encode device."""
        engine = self.engine
        dims = engine.dims
        cdt = engine._compute_dtype
        x = torch.from_numpy(samples).to(self._encode_device)
        mel = log_mel_spectrogram(
            x, self._encode_filters, n_mels=dims.n_mels, compute_dtype=torch.float32
        )
        enc_out = encode(self._encode_params, mel.to(cdt), dims)
        if self._slot_ac is not None:
            enc_out = enc_out[:, : self._slot_ac]
        prompts, cross_kv = engine._make_prompts(self._encode_params, enc_out)
        return cont.prefill_pack(
            self._encode_params, enc_out, prompts, dims, eot=self._eot,
            total_len=self._total_len, rules=engine._rules,
            logit_bias=self._encode_bias, compute_dtype=cdt,
            kv_cache_dtype=engine._kv_dtype, cross_kv=cross_kv,
        )

    def _step_bucket(self, n: int) -> None:
        """One macro-step: ``sync_every`` decode steps on the first ``n``
        slots, enqueued with no read of the device between them."""
        engine = self.engine
        sub = cont.slice_slots(self._state, n) if n < self.n_slots else self._state
        for _ in range(self.sync_every):
            cont.decode_step_slots(
                engine.assets.params, sub, engine.dims, eot=self._eot,
                sample_begin=self._p_len, rules=engine._rules,
                logit_bias=engine._logit_bias, compute_dtype=engine._compute_dtype,
            )
        if n < self.n_slots:
            cont.merge_slots(self._state, sub)

    def warmup(self) -> None:
        """Run one macro-step of every occupancy bucket on the empty pool,
        so that the first requests do not pay for the allocator's first
        blocks and the math libraries' set-up. Call it before submitting
        work. The empty slots' frozen steps write nothing an insert does
        not overwrite."""
        for b in self._buckets:
            self._step_bucket(b)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def occupancy(self) -> float:
        """Mean fraction of the FULL pool occupied across macro-steps
        (sizing signal: persistently low values mean a smaller ``n_slots``
        would serve the load)."""
        total = self._step_dispatches * self.n_slots
        return self._occupied_slot_steps / total if total else 0.0

    @property
    def dispatch_efficiency(self) -> float:
        """occupied slot-steps / dispatched slot-steps (1.0 = bucketing
        removed all the empty-slot work a fixed pool would do)."""
        return (
            self._occupied_slot_steps / self._dispatched_slot_steps
            if self._dispatched_slot_steps
            else 0.0
        )

    def _snapshot(self):
        """(active, tokens) as they stand before the next macro-step, on the
        host, and the event after which they are there. On the card the
        copies are non-blocking into pinned memory, enqueued before the
        step's kernels, so they read the pre-step values; on the CPU they
        are clones."""
        st = self._state
        if self._device.type != "cuda":
            return st.active.clone(), st.tokens.clone(), None
        active = st.active.to("cpu", non_blocking=True)
        tokens = st.tokens.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return active, tokens, event

    def _dispatch_step(self) -> None:
        occupied = [i for i, f in enumerate(self._slot_futures) if f is not None]
        bucket = next(b for b in self._buckets if b >= len(occupied))
        if occupied and occupied[-1] >= bucket:
            # Compact: move the occupied slots stranded above the bucket
            # boundary down into free rows below it (harvest freed them).
            high = [i for i in occupied if i >= bucket]
            low_free = [
                i for i, f in enumerate(self._slot_futures[:bucket]) if f is None
            ]
            for src, dst in zip(sorted(high, reverse=True), low_free):
                cont.move_slot(self._state, src, dst)
                self._slot_futures[dst] = self._slot_futures[src]
                self._slot_futures[src] = None
        self._step_dispatches += 1
        self._occupied_slot_steps += len(occupied)
        self._dispatched_slot_steps += bucket
        # Snapshot the harvest inputs (post-compaction, pre-step), with the
        # future list BY IDENTITY: a request inserted into a freed slot after
        # this snapshot must not be harvested against it (the slot reads
        # inactive with the previous occupant's tokens).
        self._pending_harvest = (*self._snapshot(), list(self._slot_futures))
        self._step_bucket(bucket)

    def _run_prefill(self, group: List[_Request]) -> cont.SlotPack:
        """One fixed-shape prefill dispatch for ≤ prefill_batch requests, on
        the encode device."""
        samples = np.zeros((self.prefill_batch, N_SAMPLES), np.float32)
        for i, r in enumerate(group):
            n = min(len(r.samples), N_SAMPLES)
            samples[i, :n] = r.samples[:n]
        self._prefill_dispatches += 1
        return self._prefill(samples)

    def _free_slots(self) -> List[int]:
        return [i for i, f in enumerate(self._slot_futures) if f is None]

    def _harvest(self) -> None:
        """Resolve futures of slots that stopped decoding; free their slots.

        Reads the snapshot taken at the LAST dispatch (lag-1): a slot that
        went inactive at step t is frozen by the active mask from then on,
        so its tokens are stable whenever read; detection costs one extra
        macro-step of slot-idle latency, and the wait is for the snapshot's
        copy, not for the step in flight."""
        if self._pending_harvest is None:
            return
        snap_active, snap_tokens, event, snap_futs = self._pending_harvest
        if event is not None:
            event.synchronize()
        active = snap_active.numpy()
        done = [
            i for i, f in enumerate(self._slot_futures)
            if f is not None and snap_futs[i] is f and not active[i]
        ]
        if not done:
            return
        lengths = cont.harvest_lengths(snap_tokens, self._p_len, self._eot).numpy()
        tokens = snap_tokens.numpy().astype(np.int32)
        for i in done:
            fut = self._slot_futures[i]
            self._slot_futures[i] = None
            try:
                fut.set_result(
                    self.engine.result_from_tokens(
                        tokens[i], int(lengths[i]), self.omit_special_tokens
                    )
                )
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)

    # --- public API --------------------------------------------------------
    def submit(self, samples: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("transcriber is closed")
        fut: Future = Future()
        self._queue.put(_Request(np.asarray(samples, np.float32), fut))
        return fut

    def transcribe(self, samples: np.ndarray) -> TranscriptionResult:
        return self.submit(samples).result()

    def close(self, wait: bool = True) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ContinuousTranscriber(_ContinuousBase):
    """Continuous-batching serving front-end (``decode/continuous.py``).

    Where :class:`AsyncTranscriber` runs whole batches in lock-step (a batch
    is as slow as its slowest decode, and arrivals wait for the batch to
    drain), this keeps a fixed pool of decode slots advancing every step:
    a finished slot is harvested and refilled while its neighbours keep
    decoding.

    Greedy decode only (beam hypotheses would multiply the slot axis);
    suppress/timestamp rules and language detection are supported. Results
    are token-identical to ``engine.transcribe`` for every utterance,
    whatever the arrival order or slot reuse, when the engine and the pool
    decode the same audio window, i.e. ``audio_ctx`` None or an int. Under
    ``audio_ctx="auto"`` the pool runs the full window while
    ``engine.transcribe`` crops short audio. The prefill takes the samples
    as float32, as JAX's does, where the engine ships them as int16 by
    default: the two agree exactly on int16-sourced audio (WAV files).
    Call :meth:`warmup` at start-up.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self, wait: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            if wait:
                self._thread.join()

    # --- worker ------------------------------------------------------------
    def _admit(self, requests: List[_Request]) -> List[_Request]:
        """Prefill utterances in fixed-size groups and insert them into free
        slots while any remain. Returns the requests that did not fit (they
        stay pending)."""
        while requests:
            free = self._free_slots()
            if not free:
                break
            group = requests[: min(len(free), self.prefill_batch)]
            requests = requests[len(group):]
            try:
                pack = self._run_prefill(group)
                for i, r in enumerate(group):
                    slot = free[i]
                    cont.insert_slot(self._state, slot, pack, i)
                    self._slot_futures[slot] = r.future
            except Exception as e:  # noqa: BLE001 — per-group error isolation
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
        return requests

    def _worker(self) -> None:
        # Harvest runs lag-1: harvesting BEFORE the next dispatch reads the
        # previous macro-step's snapshot, whose copy finished while the host
        # was admitting and enqueueing, so the wait overlaps device work.
        pending: List[_Request] = []
        while True:
            idle = not pending and all(f is None for f in self._slot_futures)
            try:
                req = self._queue.get(block=idle, timeout=None if not idle else 0.25)
                if req is None:
                    # Drain: finish everything already admitted or pending.
                    while pending or any(f is not None for f in self._slot_futures):
                        self._harvest()
                        pending = self._admit(pending)
                        if any(f is not None for f in self._slot_futures):
                            self._dispatch_step()
                    return
                pending.append(req)
                # Opportunistically drain the queue without blocking.
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._queue.put(None)  # re-post sentinel, drain first
                        break
                    pending.append(nxt)
            except queue.Empty:
                pass
            self._harvest()
            if pending:
                pending = self._admit(pending)
            if any(f is not None for f in self._slot_futures):
                self._dispatch_step()


class DisaggregatedTranscriber(_ContinuousBase):
    """Disaggregated encode → decode serving: the prefill (mel → encoder →
    cross-KV + prompt pass) and the continuous decode loop run on SEPARATE
    host threads, with independently chosen batch sizes: ``prefill_batch``
    utterances per encode dispatch feeding ``n_slots`` decode slots.

    Compared to :class:`ContinuousTranscriber`, whose single worker stalls
    the slot pool for every prefill it admits, the decode thread here never
    waits on encode: both threads enqueue work, and the card runs it in
    the order enqueued. With ``encode_device`` set to another device, the
    prefill runs there (the weights replicated once) and each pack moves to
    the decode device before its rows are inserted.

    Token-identical to ``engine.transcribe`` per utterance, under the same
    conditions as :class:`ContinuousTranscriber`.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Ready queue: prefilled packs waiting for free slots, in arrival
        # order. Bounded so encode cannot run far ahead of decode (each pack
        # holds prefill_batch × (cache + cross-KV) of device memory).
        self._ready: "queue.Queue" = queue.Queue(maxsize=4)
        self._pending_pack = None
        self._enc_thread = threading.Thread(target=self._encode_worker, daemon=True)
        self._dec_thread = threading.Thread(target=self._decode_worker, daemon=True)
        self._enc_thread.start()
        self._dec_thread.start()

    def close(self, wait: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            if wait:
                self._enc_thread.join()
                self._dec_thread.join()

    # --- encode side --------------------------------------------------------
    def _encode_worker(self) -> None:
        """Batch arrivals into fixed-size prefill groups; push packs."""
        while True:
            req = self._queue.get()
            if req is None:
                self._ready.put(None)  # decode thread drains then exits
                return
            group = [req]
            # Fill the group opportunistically (a partial group costs the
            # same dispatch).
            while len(group) < self.prefill_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post; current group first
                    break
                group.append(nxt)
            try:
                pack = self._run_prefill(group)
            except Exception as e:  # noqa: BLE001 — per-group isolation
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            self._ready.put((group, pack))

    # --- decode side --------------------------------------------------------
    def _insert_ready(self, block: bool, timeout: Optional[float]) -> bool:
        """Move prefilled utterances into free slots. Returns False once the
        encode side has signalled shutdown and everything is inserted."""
        while True:
            if self._pending_pack is None:
                try:
                    item = self._ready.get(block=block, timeout=timeout)
                except queue.Empty:
                    return True
                if item is None:
                    return False  # encode side done
                group, pack = item
                if self._encode_device != self._device:
                    # The pipeline's one inter-stage transfer.
                    pack = cont.pack_to(pack, self._device)
                self._pending_pack = (group, pack, 0)
                block = False  # only block for the first item
            group, pack, row = self._pending_pack
            free = self._free_slots()
            if not free:
                return True  # slots full; retry after stepping/harvesting
            while row < len(group) and free:
                slot = free.pop(0)
                cont.insert_slot(self._state, slot, pack, row)
                self._slot_futures[slot] = group[row].future
                row += 1
            if row < len(group):
                self._pending_pack = (group, pack, row)
                return True
            self._pending_pack = None

    def _decode_worker(self) -> None:
        draining = False
        while True:
            busy = any(f is not None for f in self._slot_futures) or (
                self._pending_pack is not None
            )
            if not draining:
                # Idle → block for work; busy → poll without blocking.
                alive = self._insert_ready(block=not busy, timeout=0.25)
                if not alive:
                    draining = True
            else:
                # Keep refilling freed slots from the pending pack while the
                # pool drains.
                self._insert_ready(block=False, timeout=None)
            if draining and self._pending_pack is None and all(
                f is None for f in self._slot_futures
            ):
                return
            # Harvest BEFORE dispatch (lag-1 snapshot — see _harvest).
            self._harvest()
            if any(f is not None for f in self._slot_futures):
                self._dispatch_step()


class StreamingSession:
    """Realtime producer/consumer session (the reference's mic pipeline,
    Whisper.java:130-174): ``write_buffer`` feeds audio from a capture
    thread; a consumer accumulates into 30 s-max utterances (optionally
    splitting at VAD silences) and emits results via the listener callback.
    """

    def __init__(
        self,
        transcriber: AsyncTranscriber,
        on_result: Callable[[TranscriptionResult], None],
        on_update: Optional[Callable[[str], None]] = None,
        min_chunk_samples: int = 16_000,  # flush granularity: 1 s
        use_vad: bool = True,
    ):
        self.transcriber = transcriber
        self.on_result = on_result
        self.on_update = on_update
        self.min_chunk = min_chunk_samples
        self.use_vad = use_vad
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def write_buffer(self, samples: np.ndarray) -> None:
        """Producer side."""
        self._queue.put(np.asarray(samples, np.float32))

    def stop(self) -> None:
        """Flush remaining audio and stop the consumer."""
        self._queue.put(None)
        self._thread.join()

    def _consume(self) -> None:
        while True:
            chunk = self._queue.get()
            if chunk is None:
                self._flush()
                return
            self._buf.append(chunk)
            self._buffered += len(chunk)
            if self._buffered >= N_SAMPLES:
                self._flush()
            elif self.use_vad and self._buffered >= self.min_chunk:
                # Flush at a trailing silence so utterances end cleanly.
                tail = chunk[-2048:]
                if len(tail) >= 512 and not energy_vad(tail).any():
                    self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        utterance = np.concatenate(self._buf)[:N_SAMPLES]
        self._buf, self._buffered = [], 0
        if self.on_update:
            self.on_update(MSG_PROCESSING)
        result = self.transcriber.transcribe(utterance)
        self.on_result(result)
