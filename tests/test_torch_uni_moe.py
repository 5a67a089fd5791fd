"""The audio language model of ``whisper_tpu_torch`` (``models/audio_lm.py``,
``ops/moe_expert.py``, ``decode/greedy.lm_greedy_decode``,
``engine/audio_lm.py``) on the CPU, at ``uni-moe-dev``: Uni-MoE-2.0-Omni's
shape at a small size (GQA 7:1 with heads of 16, 2 layers, 4 routed, 2
shared and 1 null expert, top-p 0.7 capped at 2, a vocabulary of 512, a
2-layer 128-mel tower, pool 5), in float32, against the benchmark's plain
reference (``port_bench/reference/uni_moe.py``).

Tolerances: both sides compute in float32 from the same weights and the
same int16-grid audio; they differ in the order of sums (matmul blocking,
the mel's float64 against float32, the RoPE angles' float64 against
float32), which moves a logit by ~1e-5 of the logits' scale here. Each
comparison allows 1e-3 of the largest logit's magnitude: far below the
gap a misrouted token or a dropped term opens (tenths), above the
reordering noise.
"""

import numpy as np
import pytest
import torch

from port_bench.reference.uni_moe import UniMoE
from whisper_tpu_torch.config import AUDIO_LM_DIMS, EngineConfig
from whisper_tpu_torch.decode import greedy
from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
from whisper_tpu_torch.engine.audio_lm import AudioLM
from whisper_tpu_torch.models import audio_lm
from whisper_tpu_torch.ops import moe_expert
from whisper_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

DIMS = AUDIO_LM_DIMS["uni-moe-dev"]
PRE, SUF = (3, 14, 15, 92, 65), (35, 89, 79)
# The reference reads the published config's keys; these are the dev sizes.
SIZES = {
    "hidden_size": DIMS.n_state, "num_attention_heads": DIMS.n_head,
    "num_key_value_heads": DIMS.n_kv_head, "rms_norm_eps": DIMS.norm_eps,
    "rope_theta": DIMS.rope_theta, "mlp_dynamic_expert_num": DIMS.n_routed,
    "mlp_fixed_expert_num": DIMS.n_shared, "shared_intermediate_size": DIMS.shared_width,
    "mlp_dynamic_top_p": DIMS.top_p, "mlp_dynamic_top_k": DIMS.top_k, "whisper_audio_time": 20,
    "whisper_query_tokens_size": 200,
    "tower": {"encoder_attention_heads": DIMS.tower.n_audio_head, "num_mel_bins": 128},
}
TOL = 1e-3


def _clips(seconds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        x = 0.1 * rng.standard_normal(int(s * 16_000))
        out.append((np.clip(np.rint(x * 32768), -32768, 32767) / 32768).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def engine():
    cfg = EngineConfig(model="uni-moe-dev", dtype="float32", max_new_tokens=6,
                       lm_prefix_tokens=PRE, lm_suffix_tokens=SUF)
    return create_engine(EngineType.MONOLITH, cfg, seed=11, device="cpu")


class _Record:
    """Wraps ``audio_lm.prefill``, ``step`` and ``route`` to keep what they
    return, in call order."""

    def __init__(self, monkeypatch):
        self.prefill, self.step, self.route = [], [], []
        for name in ("prefill", "step", "route"):
            real = getattr(audio_lm, name)

            def wrap(*a, _real=real, _keep=getattr(self, name), **k):
                out = _real(*a, **k)
                _keep.append(out)
                return out

            monkeypatch.setattr(audio_lm, name, wrap)


def _reference_rows(engine, clips, tokens=None):
    """The reference's input embeddings of each row: its prompt, its audio
    positions, then ``tokens[i]`` fed (if given)."""
    ref = UniMoE(engine.params, SIZES)
    audio = ref.audio(clips, "cpu")
    rows = []
    for i, a in enumerate(audio):
        parts = [ref.embed(PRE), a, ref.embed(SUF)]
        if tokens is not None:
            parts.append(ref.embed(tokens[i]))
        rows.append(torch.cat(parts))
    return ref, rows


def _program_routing(engine, route_calls, clips, n_steps=0):
    """The program's routing per layer, per row, at each of the row's own
    positions: the prefill's (pad positions dropped), then each step's."""
    n = [audio_lm.audio_positions(len(c), DIMS) for c in clips]
    lay = audio_lm.prefix_layout(n, len(PRE), len(SUF), 200)
    b, p = len(clips), lay["P"]
    layers = DIMS.n_layer
    out = [[[] for _ in range(b)] for _ in range(layers)]
    for call, (_, _, picked, idx) in enumerate(route_calls[: layers * (1 + n_steps)]):
        li = call % layers
        if call < layers:
            idx, picked = idx.view(b, p, -1), picked.view(b, p, -1)
            for i in range(b):
                out[li][i].append((idx[i, lay["pad"][i]:], picked[i, lay["pad"][i]:]))
        else:
            for i in range(b):
                out[li][i].append((idx[i:i + 1], picked[i:i + 1]))
    return [[(torch.cat([x for x, _ in parts]), torch.cat([y for _, y in parts]))
             for parts in per_layer] for per_layer in out]


def _close(a, b):
    return float((a - b).abs().max()) <= TOL * float(b.abs().max())


def test_prefill_logits_against_reference(engine, monkeypatch):
    rec = _Record(monkeypatch)
    clips = _clips([0.7, 1.6, 3.1])
    engine.transcribe_batch(clips)
    logits = rec.prefill[0]
    ref, rows = _reference_rows(engine, clips)
    want = ref.logits(rows, [1] * len(rows), routing=_program_routing(engine, rec.route, clips))
    for i in range(len(clips)):
        assert _close(logits[i], want[i][0]), i


def test_routing_equal_away_from_boundary(engine, monkeypatch):
    rec = _Record(monkeypatch)
    clips = _clips([1.2, 2.5], seed=3)
    engine.transcribe_batch(clips)
    ref, rows = _reference_rows(engine, clips)
    ref.logits(rows, [1] * len(rows))  # the reference's own routing
    ours = _program_routing(engine, rec.route, clips)
    checked = 0
    for li in range(DIMS.n_layer):
        for i in range(len(clips)):
            idx, picked = ours[li][i]
            r_idx, r_picked = ref.chosen[li][i]
            far = ref.margins[li][i] > 1e-4
            assert torch.equal(picked[far], r_picked[far])
            assert torch.equal(torch.where(picked, idx, -1)[far],
                               torch.where(r_picked, r_idx, -1)[far])
            checked += int(far.sum())
    assert checked > 0.9 * sum(r.shape[0] for r in rows) * DIMS.n_layer


def test_engine_keeps_the_routing_of_every_position(engine, monkeypatch):
    """``AudioLM.last_routing``: each row's prefix positions and each step,
    as the router chose them (``route_codes``: the slot's gate output, -1
    where it is not taken); a step past the budget stays -1."""
    rec = _Record(monkeypatch)
    clips = _clips([0.8, 2.9], seed=9)
    engine.transcribe_batch(clips)
    steps = len(rec.step)
    ours = _program_routing(engine, rec.route, clips, steps)
    assert len(engine.last_routing) == len(clips)
    for i, (pre, step) in enumerate(engine.last_routing):
        n = len(PRE) + len(SUF) + audio_lm.audio_positions(len(clips[i]), DIMS)
        assert pre.shape == (DIMS.n_layer, n, DIMS.top_k) and pre.dtype == np.int8
        assert step.shape == (DIMS.n_layer, engine._max_new, DIMS.top_k)
        for li in range(DIMS.n_layer):
            idx, picked = ours[li][i]
            want = torch.where(picked, idx, -1).numpy()
            got = np.concatenate([pre[li], step[li, :steps]])
            assert np.array_equal(got, want), (i, li)
        assert (step[:, steps:] == -1).all()


def test_cached_decode_against_full_forward(engine, monkeypatch):
    """Prefill, then each cached step, against the reference's forward over
    the whole sequence at that length (the program's routing given)."""
    rec = _Record(monkeypatch)
    clips = _clips([0.9, 2.2], seed=5)
    res = engine.transcribe_batch(clips)
    steps = len(rec.step)
    assert steps == engine._max_new - 1
    got = [torch.stack([rec.prefill[0][i]] + [s[i] for s in rec.step]) for i in range(len(clips))]
    fed = [r.tokens[:steps] for r in res]
    ref, rows = _reference_rows(engine, clips, fed)
    want = ref.logits(rows, [steps + 1] * len(rows),
                      routing=_program_routing(engine, rec.route, clips, steps))
    for i in range(len(clips)):
        assert _close(got[i], want[i]), i
        # the served tokens are the program's own picks
        assert res[i].tokens[: steps + 1].tolist() == got[i].argmax(-1).tolist()


def test_ragged_batch_row_by_row(engine, monkeypatch):
    rec = _Record(monkeypatch)
    clips = _clips([0.4, 2.8, 1.5], seed=7)
    batch = engine.transcribe_batch(clips)
    together = rec.prefill[0]
    for i, clip in enumerate(clips):
        alone = engine.transcribe_batch([clip])
        assert _close(rec.prefill[-1][0], together[i])
        assert alone[0].tokens.tolist() == batch[i].tokens.tolist()
        assert alone[0].length == batch[i].length


@pytest.mark.parametrize("probs,experts,weights", [
    ([0.75, 0.1, 0.05, 0.05, 0.05], [0, 4], [0.75, 0.0]),  # p1 ≥ 0.7: one expert
    ([0.1, 0.5, 0.3, 0.05, 0.05], [1, 2], [0.5, 0.3]),  # p1 < 0.7: two
    ([0.05, 0.05, 0.1, 0.05, 0.75], [4, 4], [0.0, 0.0]),  # the null expert alone
    ([0.05, 0.45, 0.05, 0.05, 0.4], [1, 4], [0.45, 0.0]),  # a routed one and the null
])
def test_router_on_hand_made_probabilities(probs, experts, weights):
    p = torch.tensor([probs], dtype=torch.float64)
    gate = torch.eye(5)
    expert, weight, picked, idx = audio_lm.route(gate, torch.log(p).float(), DIMS)
    assert expert[0].tolist() == experts
    assert torch.allclose(weight[0], torch.tensor(weights), atol=1e-6)
    assert picked[0].tolist() == [True, probs[int(idx[0, 0])] < 0.7]


def test_null_expert_gives_the_shared_output_alone():
    gen = torch.Generator().manual_seed(4)
    params = audio_lm.init_lm_params(DIMS, gen)
    bp = dict(params["blocks"][0])
    bp["gate"] = torch.zeros_like(bp["gate"])
    bp["gate"][:, DIMS.n_routed] = 50.0  # every positive row picks the null expert
    h = torch.rand((6, DIMS.n_state), generator=gen) + 0.1
    counters, tally = audio_lm.new_counters(DIMS, "cpu"), []
    y = audio_lm.moe(bp, h, DIMS, tally=tally)
    audio_lm.count(counters, audio_lm.PREFILL, tally, DIMS)
    s = bp["shared"]
    shared = (torch.nn.functional.silu(h @ s["w_gate"]) * (h @ s["w_up"])) @ s["w_down"]
    assert torch.allclose(y, shared, rtol=1e-5, atol=1e-6)
    c = audio_lm.counters_dict(counters[audio_lm.PREFILL].numpy(), DIMS)
    assert c["null_picks"] == 6 and c["rows"] == 0 and c["touched"] == 0 and c["calls"] == 1


def test_moe_experts_plan_and_plain_version():
    """``plan`` sorts the pairs by expert, stable, the unrouted last; the
    plain version equals a dense sum over every expert."""
    gen = torch.Generator().manual_seed(2)
    e, d, f, n = 4, 16, 24, 9
    expert = torch.randint(0, e + 1, (n, 2), generator=gen)
    weight = torch.rand((n, 2), generator=gen)
    order, counts = moe_expert.plan(expert, e)
    flat = expert.reshape(-1)
    assert counts.tolist() == [int((flat == i).sum()) for i in range(e)]
    assert flat[order.long()].tolist() == sorted(flat.tolist())
    for i in range(e + 1):
        ids = order[flat[order.long()] == i].tolist()
        assert ids == sorted(ids)
    x = torch.randn((n, d), generator=gen)
    wg, wu, wd = (torch.randn(s, generator=gen) for s in ((e, d, f), (e, d, f), (e, f, d)))
    y, c2 = moe_expert.moe_experts(x, expert, weight, wg, wu, wd)
    dense = torch.zeros(n, d)
    for t in range(n):
        for j in range(2):
            k = int(expert[t, j])
            if k < e:
                dense[t] += weight[t, j] * (
                    (torch.nn.functional.silu(x[t] @ wg[k]) * (x[t] @ wu[k])) @ wd[k])
    assert torch.allclose(y, dense, rtol=1e-5, atol=1e-5) and torch.equal(c2, counts)


def test_spans_and_counters(engine):
    from torch.autograd import profiler as autograd_profiler

    audio_lm.routing.clear()
    prof.reset_spans()
    autograd_profiler.profile(use_kineto=True, use_cpu=True).__enter__()
    torch._C._autograd._disable_profiler()  # recording stays on, as after a traced slice
    try:
        steps0 = greedy.steps
        engine.transcribe_batch(_clips([0.5, 1.0], seed=9))
        spans = prof.spans()
    finally:
        autograd_profiler._set_is_profiler_enabled(False)
        prof.reset_spans()
    names = {s.name for s in spans}
    assert {"engine.batch", "engine.prepare", "engine.encode", "lm.project", "lm.prefill",
            "decode.loop", "decode.step", "decode.sync", "engine.fetch",
            "engine.results"} <= names
    root = next(s for s in spans if s.name == "engine.batch")
    assert root.parent is None and root.attrs["rows"] == 2
    assert all(s.trace_id == root.trace_id for s in spans)
    pre = next(s for s in spans if s.name == "lm.prefill")
    n_pos = len(PRE) + len(SUF) + audio_lm.audio_positions(16_000, DIMS)
    assert pre.attrs == {"rows": 2, "prefix_len": n_pos}
    loop = next(s for s in spans if s.name == "decode.loop")
    steps = greedy.steps - steps0
    assert loop.attrs == {"steps": steps, "graphed": 0}  # no graphs on the CPU
    r = audio_lm.routing
    assert r["prefill"]["calls"] == DIMS.n_layer and r["step"]["calls"] == DIMS.n_layer * steps
    for phase in r.values():
        assert sum(phase["picks"]) == phase["rows"] + phase["null_picks"]
        assert phase["null_picks"] == phase["picks"][DIMS.n_routed]
    # the prefill routes the rows' own positions only, one or two slots each
    assert n_pos * DIMS.n_layer < sum(r["prefill"]["picks"]) <= 2 * (2 * n_pos) * DIMS.n_layer


@pytest.mark.parametrize("beam", [1, 3])
def test_whisper_engine_unchanged(beam):
    """``create_engine`` hands Whisper models to the Whisper engines as
    before: the same tokens as ``Monolith`` built directly."""
    cfg = EngineConfig(model="tiny", dtype="float32", beam_size=beam, max_new_tokens=5,
                       language="en")
    audio = _clips([1.5, 2.5], seed=1)
    batch = np.zeros((2, 40_000), np.float32)
    for i, c in enumerate(audio):
        batch[i, : len(c)] = c
    made = create_engine(EngineType.MONOLITH, cfg, seed=0, device="cpu")
    direct = Monolith.from_random(cfg, seed=0, device="cpu")
    assert type(made) is Monolith
    a, b = made.transcribe_batch(batch), direct.transcribe_batch(batch)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]


def test_engine_refuses_what_it_does_not_run():
    for bad in ({"beam_size": 2}, {"quantization": "int8"}, {"audio_ctx": 512}):
        with pytest.raises(ValueError):
            AudioLM.from_random(EngineConfig(model="uni-moe-dev", **bad), device="cpu")
    with pytest.raises(ValueError):
        create_engine(EngineType.ENCDEC, EngineConfig(model="uni-moe-dev"), device="cpu")
