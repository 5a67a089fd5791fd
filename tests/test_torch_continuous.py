"""The port's slot pool (decode/continuous.py, engine/serving.py's
ContinuousTranscriber and DisaggregatedTranscriber) against whisper_tpu.

Both engines hold the same weights (``params_from_jax``) at ``dev`` dims,
float32, ``max_new_tokens=8``, ``audio_ctx=None`` (the pool always decodes
the full window). Every slot-pool result must have tokens, length and text
EQUAL to JAX's ``engine.transcribe`` of the same utterance, whatever the
arrival order, slot reuse or bucketing. The utterances are int16-exact
(as a WAV file's are), since the engine ships audio as int16 and the
prefill takes it as float32, on both sides. The slot-state primitives
(``insert_slot``, ``move_slot``, ``harvest_lengths``) are held against
JAX's on the same state, and the occupancy accounting against JAX's pool
under the same arrival script.
"""

from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode import continuous as jcont
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.engine import serving as jserving
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.decode import continuous as tcont
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.engine import serving as tserving
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

CFG = dict(model="dev", language="en", dtype="float32", max_new_tokens=8, audio_ctx=None)
TIMEOUT = 120


def _utterances(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = 0.1 * rng.standard_normal(rng.integers(8_000, 64_000))
        out.append((np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32))
    return out


UTTS = _utterances(8, seed=3)


@pytest.fixture(scope="module")
def engines():
    dims = JaxConfig(**CFG).dims()
    tree = jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(5)))
    ref = jax_create_engine(JaxType.ENCDEC, JaxConfig(**CFG), params=tree)
    ours = create_engine(EngineType.ENCDEC, EngineConfig(**CFG), params=params_from_jax(tree), device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def expected(engines):
    """JAX's engine.transcribe of every utterance of UTTS, once."""
    return [engines[0].transcribe(u) for u in UTTS]


def _assert_equal(results, expected):
    assert len(results) == len(expected)
    for got, exp in zip(results, expected):
        assert got.length == exp.length
        np.testing.assert_array_equal(got.tokens[: got.length], exp.tokens[: exp.length])
        assert got.text == exp.text
        assert got.language == exp.language


def _serve(transcriber, utts):
    with transcriber as t:
        futures = [t.submit(u) for u in utts]
        return [f.result(timeout=TIMEOUT) for f in futures]


@pytest.mark.parametrize("cls", ["ContinuousTranscriber", "DisaggregatedTranscriber"])
@pytest.mark.parametrize(
    "n_slots, prefill_batch, n_utts",
    [(3, 2, 5), (2, 1, 8)],  # the second: more utterances than slots, slots reused
)
def test_pool_equal_to_jax_transcribe(engines, expected, cls, n_slots, prefill_batch, n_utts):
    pool = getattr(tserving, cls)(engines[1], n_slots=n_slots, prefill_batch=prefill_batch)
    _assert_equal(_serve(pool, UTTS[:n_utts]), expected[:n_utts])


@pytest.mark.parametrize("cls", ["ContinuousTranscriber", "DisaggregatedTranscriber"])
def test_staggered_arrivals(engines, expected, cls):
    with getattr(tserving, cls)(engines[1], n_slots=2, prefill_batch=2) as t:
        first = [t.submit(u) for u in UTTS[:2]]
        r0 = first[0].result(timeout=TIMEOUT)  # wait mid-stream
        rest = [t.submit(u) for u in UTTS[2:5]]
        results = [r0] + [f.result(timeout=TIMEOUT) for f in first[1:] + rest]
    _assert_equal(results, expected[:5])


def test_disaggregated_with_an_explicit_encode_device(engines, expected):
    """``encode_device`` names the engine's own device: prefill on its own
    thread, the same weights, no replica."""
    pool = tserving.DisaggregatedTranscriber(engines[1], n_slots=2, prefill_batch=2, encode_device="cpu")
    assert pool._encode_params is engines[1].assets.params
    _assert_equal(_serve(pool, UTTS[:4]), expected[:4])


def test_close_drains_pending(engines):
    t = tserving.ContinuousTranscriber(engines[1], n_slots=2, prefill_batch=2)
    futures = [t.submit(u) for u in UTTS[:4]]
    t.close(wait=False)  # the worker finishes everything already submitted
    t._thread.join(timeout=TIMEOUT)
    assert not t._thread.is_alive()
    assert all(f.done() and f.result(timeout=0).length >= 1 for f in futures)
    with pytest.raises(RuntimeError):
        t.submit(UTTS[0])


def test_beam_refused(engines):
    beam = create_engine(
        EngineType.ENCDEC, EngineConfig(**dict(CFG, beam_size=2)),
        params=engines[1].assets.params, device="cpu",
    )
    for cls in (tserving.ContinuousTranscriber, tserving.DisaggregatedTranscriber):
        with pytest.raises(ValueError, match="greedy-only"):
            cls(beam)


@pytest.mark.parametrize("cls", ["ContinuousTranscriber", "DisaggregatedTranscriber"])
def test_error_isolation(engines, expected, cls):
    """A request whose prefill fails fails its own group's future; the pool
    goes on serving the next."""
    with getattr(tserving, cls)(engines[1], n_slots=2, prefill_batch=1) as t:
        bad = t.submit(np.zeros((2, 100), np.float32))  # 2-D: the prefill's copy raises
        with pytest.raises(ValueError):
            bad.result(timeout=TIMEOUT)
        good = t.submit(UTTS[0]).result(timeout=TIMEOUT)
    _assert_equal([good], expected[:1])


def test_bucketed_dispatch_compacts_and_matches(engines, expected):
    """Occupied slots stranded above the bucket boundary are moved down
    (move_slot) and decoding goes on in the half-pool bucket."""
    base = tserving._ContinuousBase(engines[1], n_slots=4, prefill_batch=2)
    assert base._buckets == [2, 4]
    reqs = [tserving._Request(u, Future()) for u in UTTS[:2]]
    pack = base._run_prefill(reqs)
    # Insert at the HIGH slots, so that the first bucketed dispatch compacts.
    tcont.insert_slot(base._state, 2, pack, 0)
    tcont.insert_slot(base._state, 3, pack, 1)
    base._slot_futures[2] = reqs[0].future
    base._slot_futures[3] = reqs[1].future

    base._dispatch_step()
    assert base._dispatched_slot_steps == 2
    assert [f is not None for f in base._slot_futures] == [True, True, False, False]
    assert base._slot_futures[0] is reqs[1].future  # highest source moved first
    assert base._slot_futures[1] is reqs[0].future
    for _ in range(64):
        base._harvest()
        if all(f is None for f in base._slot_futures):
            break
        base._dispatch_step()
    assert all(f is None for f in base._slot_futures)
    assert base._dispatched_slot_steps == 2 * base._step_dispatches
    _assert_equal([r.future.result(timeout=0) for r in reqs], expected[:2])


def test_slot_buckets_disabled(engines, expected):
    with tserving.ContinuousTranscriber(engines[1], n_slots=4, prefill_batch=2, slot_buckets=[4]) as t:
        results = [f.result(timeout=TIMEOUT) for f in [t.submit(u) for u in UTTS[:3]]]
        assert t._dispatched_slot_steps == 4 * t._step_dispatches
    _assert_equal(results, expected[:3])


def _scripted(base, admit, dispatch, utts):
    """One arrival script, run by hand on a slot-pool base: three
    utterances at the start, three more after the second macro-step, one
    more after the fifth; harvest before every dispatch, as the workers
    do. Returns the futures."""
    waves = {0: utts[:3], 2: utts[3:6], 5: utts[6:7]}
    pending, futures, step = [], [], 0
    while True:
        for u in waves.get(step, []):
            futures.append(Future())
            pending.append((u, futures[-1]))
        base._harvest()
        pending = admit(pending)
        if any(f is not None for f in base._slot_futures):
            dispatch()
        elif not pending and step > max(waves):
            return futures
        step += 1
        if step > 200:
            raise AssertionError("script did not finish")


def test_occupancy_equal_to_jax(engines, expected):
    """The same arrival script through JAX's pool and the port's: the same
    macro-steps, occupancy, dispatch efficiency and tokens."""
    ref, ours = engines
    utts = UTTS[:7]

    def run(mod, engine, step):
        base = mod._ContinuousBase(engine, n_slots=4, prefill_batch=2)

        def admit(pending):
            reqs = [mod._Request(u, f) for u, f in pending]
            left = mod.ContinuousTranscriber._admit(base, reqs)
            return [(r.samples, r.future) for r in left]

        futures = _scripted(base, admit, lambda: step(base), utts)
        return base, [f.result(timeout=0) for f in futures]

    def jax_step(base):
        base._state = base._dispatch_step()

    jbase, jres = run(jserving, ref, jax_step)
    tbase, tres = run(tserving, ours, lambda b: b._dispatch_step())
    assert tbase._step_dispatches == jbase._step_dispatches
    assert tbase._occupied_slot_steps == jbase._occupied_slot_steps
    assert tbase._dispatched_slot_steps == jbase._dispatched_slot_steps
    assert tbase.occupancy == jbase.occupancy and 0 < tbase.occupancy <= 1
    assert tbase.dispatch_efficiency == jbase.dispatch_efficiency
    _assert_equal(tres, jres)
    _assert_equal(tres, expected[:7])


# --- slot-state primitives against JAX's --------------------------------------


@pytest.fixture(scope="module")
def states(engines):
    """A 3-slot JAX state and the port's copy of it (same bytes), and a
    2-row pack of each from the same prefill inputs."""
    ref, ours = engines
    jbase = jserving._ContinuousBase(ref, n_slots=3, prefill_batch=2)
    tbase = tserving._ContinuousBase(ours, n_slots=3, prefill_batch=2)
    reqs = [jserving._Request(u, Future()) for u in UTTS[:2]]
    jpack = jbase._run_prefill(reqs)
    tpack = tbase._run_prefill([tserving._Request(r.samples, Future()) for r in reqs])
    return jpack, tpack


def _state_pair(seed, total=12):
    """A JAX SlotState with random contents (``dev`` geometry, ``total``
    positions) and the port's equal copy."""
    rng = np.random.default_rng(seed)
    s, layers, h, dh, ac = 3, 2, 2, 32, 1500
    tokens = rng.integers(0, 50000, (s, total)).astype(np.int32)
    tokens[0, 7:] = 50257
    tokens[2, 5] = 50257
    pos = np.array([7, 11, 6], np.int32)
    active = np.array([False, True, False])
    cache = {n: rng.standard_normal((layers, s, total, h, dh)).astype(np.float32) for n in "kv"}
    cross = {n: rng.standard_normal((layers, s, h, dh, ac)).astype(np.float32) for n in "kv"}
    jst = jcont.SlotState(
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(active),
        {n: jnp.asarray(x) for n, x in cache.items()}, {n: jnp.asarray(x) for n, x in cross.items()},
    )
    tst = tcont.SlotState(
        torch.from_numpy(tokens).long(), torch.from_numpy(pos).long(), torch.from_numpy(active),
        {n: torch.from_numpy(x.copy()) for n, x in cache.items()},
        {n: torch.from_numpy(x.copy()) for n, x in cross.items()},
    )
    return jst, tst


def _assert_state_equal(t, j):
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    for n in ("k", "v"):
        np.testing.assert_array_equal(t.cache[n].numpy(), np.asarray(j.cache[n]))
        np.testing.assert_array_equal(t.cross_kv[n].numpy(), np.asarray(j.cross_kv[n]))


@pytest.mark.parametrize("src, dst", [(1, 0), (2, 0), (0, 2)])
def test_move_slot_equal_to_jax(src, dst):
    jst, tst = _state_pair(1)
    j = jcont.move_slot(jst, jnp.int32(src), jnp.int32(dst))
    t = tcont.move_slot(tst, src, dst)
    _assert_state_equal(t, j)


def test_harvest_lengths_equal_to_jax():
    jst, tst = _state_pair(2)
    want = np.asarray(jcont.harvest_lengths(jst.tokens, 4, 50257))
    np.testing.assert_array_equal(tcont.harvest_lengths(tst.tokens, 4, 50257).numpy(), want)
    assert want.tolist() == [8, 12, 6]


@pytest.mark.parametrize("slot, row", [(0, 1), (2, 0)])
def test_insert_slot_equal_to_jax(engines, states, slot, row):
    """A prefill pack from each side (allclose: the same prefill in another
    order of f32 sums) inserted into an equal state: the slot then holds
    the pack's row on both sides, and the other slots are untouched."""
    jpack, tpack = states
    np.testing.assert_array_equal(tpack.tokens.numpy(), np.asarray(jpack.tokens))
    np.testing.assert_array_equal(tpack.pos.numpy(), np.asarray(jpack.pos))
    np.testing.assert_array_equal(tpack.still_active.numpy(), np.asarray(jpack.still_active))
    for n in ("k", "v"):
        np.testing.assert_allclose(tpack.cache[n].numpy(), np.asarray(jpack.cache[n]), atol=1e-4)
        np.testing.assert_allclose(tpack.cross_kv[n].numpy(), np.asarray(jpack.cross_kv[n]), atol=1e-4)
    # Insert the port's own pack rows into equal states; JAX inserts the
    # same values (the port's pack handed over), so the states stay equal.
    jst, tst = _state_pair(3, total=tpack.tokens.shape[1])
    same_pack = jcont.SlotPack(
        jnp.asarray(tpack.tokens.numpy().astype(np.int32)), jnp.asarray(tpack.pos.numpy().astype(np.int32)),
        jnp.asarray(tpack.still_active.numpy()),
        {n: jnp.asarray(tpack.cache[n].numpy()) for n in "kv"},
        {n: jnp.asarray(tpack.cross_kv[n].numpy()) for n in "kv"},
    )
    j = jcont.insert_slot(jst, jnp.int32(slot), same_pack, row)
    t = tcont.insert_slot(tst, slot, tpack, row)
    _assert_state_equal(t, j)


def test_slice_and_merge_slots_equal_to_jax():
    """A stepped prefix sub-pool merged back: JAX's copy-back and the port's
    in-place views give the same state; a sub-pool that is not a view (a
    clone) is copied back the same way. cross_kv is never written back."""
    jst, tst = _state_pair(4)

    jsub = jcont.slice_slots(jst, 2)
    jsub = jsub._replace(
        tokens=jsub.tokens.at[:, 9].set(77), pos=jsub.pos + 1, active=~jsub.active,
        cache={n: x * 2 for n, x in jsub.cache.items()},
        cross_kv={n: x * 3 for n, x in jsub.cross_kv.items()},
    )
    want = jcont.merge_slots(jst, jsub)
    for clone in (False, True):
        _, t = _state_pair(4)
        sub = tcont.slice_slots(t, 2)
        if clone:
            sub = tcont.SlotState(sub.tokens.clone(), sub.pos.clone(), sub.active.clone(),
                                  {n: x.clone() for n, x in sub.cache.items()}, dict(sub.cross_kv))
        sub.tokens[:, 9] = 77
        sub.pos.add_(1)
        sub.active.logical_not_()
        for x in sub.cache.values():
            x.mul_(2)
        _assert_state_equal(tcont.merge_slots(t, sub), want)
