"""The decode step with its position on the device (``decode/graph.py``),
run eagerly step by step on the CPU, against the loops' eager steps.

A ``StepGraphs`` handed to ``greedy_decode`` or to ``beam_decode`` in its
"hybrid" mode makes every step after the first pick read its position
from a device tensor and keep its state in static buffers; on the CPU
nothing is captured, so the same step function runs eagerly. At ``dev``
dims in float32, over several seeds, with the suppress rules (timestamps
on and off) and ``no_speech``:

* greedy tokens and lengths EQUAL to the eager loop's, the no-speech
  probability equal, the logprob sums to 1e-5 (f32 sums whose attention
  reads the whole cache: another order of the same sums);
* beam "hybrid" (K2's plain version with a tensor position) tokens and
  lengths EQUAL, normalised scores to 1e-5;
* the masked whole-cache self-attention equal to the window read to 1e-6,
  K2's plain version at a tensor position bitwise its int form, and the
  static buffers reused across calls of one shape and shared by the
  entries of one buffer shape (cross-K/V crops, prompt lengths of one
  cache length), entries dropped least recently used first and buffers
  once no entry uses them;
* the ``decode.loop`` span's ``graphed`` attribute, the module counters,
  and ``port_bench``'s ``decode_graph_share.offline`` on made spans.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode import beam, graph, greedy
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.models import decoder as dec
from whisper_tpu_torch.models import layers
from whisper_tpu_torch.models.params import init_params
from whisper_tpu_torch.ops import fused_step
from whisper_tpu_torch.tokenizer.vocab import Vocab
from whisper_tpu_torch.utils import profiling

torch.set_num_threads(2)

DIMS = dataclasses.replace(MODEL_DIMS["dev"], n_audio_ctx=40)
EOT, SOT, NOSPEECH = 50257, 50258, 50362
PROMPT = torch.tensor([[SOT, 50259, 50359, 50363]] * 3)
ROOT = Path(__file__).resolve().parent.parent


def _model(seed):
    params = init_params(DIMS, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    enc = torch.randn((3, 40, DIMS.n_audio_state), generator=gen)
    return params, enc


def _rules(timestamps):
    vocab = Vocab.synthetic(multilingual=True)
    return make_rules(vocab, timestamps=timestamps, n_vocab=DIMS.n_vocab)


@pytest.mark.parametrize("timestamps", [False, True], ids=["rules", "timestamps"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_device_position_equals_eager(seed, timestamps):
    params, enc = _model(seed)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=9, rules=_rules(timestamps),
              return_logprobs=True, no_speech=(0, NOSPEECH))
    steps0 = greedy.steps
    want = greedy.greedy_decode(params, enc, PROMPT, **kw)
    steps1, replays0 = greedy.steps, graph.replays
    got = greedy.greedy_decode(params, enc, PROMPT, graphs=graph.StepGraphs(), **kw)
    assert greedy.steps - steps1 == steps1 - steps0 > 0
    assert graph.replays == replays0  # the CPU captures nothing
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("kv", [None, torch.float8_e4m3fn], ids=["f32", "fp8"])
@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_device_position_plain(seed, kv):
    """No rules and no logprobs; an fp8 cache."""
    params, enc = _model(seed)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=7, kv_cache_dtype=kv)
    want = greedy.greedy_decode(params, enc, PROMPT, **kw)
    got = greedy.greedy_decode(params, enc, PROMPT, graphs=graph.StepGraphs(), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_greedy_with_temperature_keeps_the_eager_loop():
    """With a temperature the loop takes no entry: the buffers stay empty."""
    params, enc = _model(5)
    graphs = graph.StepGraphs()
    gen = torch.Generator().manual_seed(0)
    greedy.greedy_decode(params, enc, PROMPT, DIMS, EOT, 4, temperature=0.0, generator=gen,
                         graphs=graphs)
    assert len(graphs) == 0


@pytest.mark.parametrize("timestamps", [False, True], ids=["rules", "timestamps"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_hybrid_device_position_equals_eager(seed, timestamps):
    params, enc = _model(seed)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=9, beam_size=3, rules=_rules(timestamps),
              no_speech=(0, NOSPEECH), fused="hybrid")
    want = beam.beam_decode(params, enc, PROMPT, **kw)
    got = beam.beam_decode(params, enc, PROMPT, graphs=graph.StepGraphs(), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("seed", [6, 7])
def test_beam_hybrid_device_position_int8_fp8(seed):
    """The flagship's formats at ``dev`` width: int8 weights, an fp8 cache."""
    from whisper_tpu_torch.models.quantize import quantize_params

    params, enc = _model(seed)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=8, beam_size=3, rules=_rules(False),
              fused="hybrid", kv_cache_dtype=torch.float8_e4m3fn)
    params = quantize_params(params)
    want = beam.beam_decode(params, enc, PROMPT, **kw)
    got = beam.beam_decode(params, enc, PROMPT, graphs=graph.StepGraphs(), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", ["off", "lineage"])
def test_beam_other_modes_keep_the_eager_loop(fused):
    params, enc = _model(8)
    graphs = graph.StepGraphs()
    beam.beam_decode(params, enc, PROMPT, DIMS, EOT, 4, beam_size=2, fused=fused, graphs=graphs)
    assert len(graphs) == 0


def test_buffers_reused_across_calls_of_one_shape():
    params, enc = _model(9)
    graphs = graph.StepGraphs()
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=6, rules=_rules(False))
    first = greedy.greedy_decode(params, enc, PROMPT, graphs=graphs, **kw)
    (entry,) = graphs._entries.values()
    second = greedy.greedy_decode(params, enc, PROMPT, graphs=graphs, **kw)
    assert len(graphs) == 1 and next(iter(graphs._entries.values())) is entry
    assert torch.equal(first[0], second[0])
    # Another budget is another shape key.
    greedy.greedy_decode(params, enc, PROMPT, graphs=graphs, **dict(kw, max_new_tokens=5))
    assert len(graphs) == 2


def test_cache_drops_the_least_recently_used():
    graphs = graph.StepGraphs(size=2)
    made = []

    def make(name):
        return lambda: made.append(name) or name

    graphs.entry("a", make("a"))
    graphs.entry("b", make("b"))
    graphs.entry("a", make("a2"))  # a is the most recent now
    graphs.entry("c", make("c"))  # drops b
    assert list(graphs._entries) == ["a", "c"] and made == ["a", "b", "c"]


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_crops_and_prompt_lengths_share_the_buffers(mode):
    """Two cross-K/V crops, and a longer prompt with the same cache
    length, are three entries over one set of buffers; each decode equals
    the eager loop's."""
    params, enc = _model(15)
    graphs = graph.StepGraphs()
    long_prompt = torch.cat([PROMPT, PROMPT[:, -1:]], dim=1)
    kw = dict(dims=DIMS, eot=EOT, rules=_rules(False))
    if mode == "beam":
        kw.update(beam_size=2, fused="hybrid")
    run = beam.beam_decode if mode == "beam" else greedy.greedy_decode
    for x, prompt, budget in ((enc, PROMPT, 8), (enc[:, :24], PROMPT, 8), (enc, long_prompt, 7)):
        want = run(params, x, prompt, max_new_tokens=budget, **kw)
        got = run(params, x, prompt, max_new_tokens=budget, graphs=graphs, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(graphs) == 3 and len(graphs._buffers) == 1
    assert len({id(e.buffers) for e in graphs._entries.values()}) == 1


def test_buffers_no_entry_uses_are_dropped():
    graphs = graph.StepGraphs(size=2)
    made = []

    def make(name):
        return lambda: made.append(name) or name

    graphs.entry("a", make("x"), share="x")
    graphs.entry("b", make("x2"), share="x")  # x's buffers again
    graphs.entry("c", make("y"), share="y")  # drops a; b still holds x
    assert made == ["x", "y"] and set(graphs._buffers) == {"x", "y"}
    graphs.entry("d", make("z"), share="z")  # drops b, the last user of x
    assert made == ["x", "y", "z"] and set(graphs._buffers) == {"y", "z"}
    assert graphs._entries["c"].buffers == "y"


def test_cross_crop_is_a_contiguous_view_at_the_start():
    cross = graph.cross_buffers(DIMS, 3, torch.float32, "cpu")
    assert cross["k"].shape == (DIMS.n_text_layer, 3, DIMS.n_text_head,
                                DIMS.n_text_state // DIMS.n_text_head, DIMS.n_audio_ctx)
    for ctx in (7, DIMS.n_audio_ctx):
        views = graph.crop(cross, ctx)
        again = graph.crop(cross, ctx)
        for n in ("k", "v"):
            assert views[n].shape == cross[n].shape[:-1] + (ctx,) and views[n].is_contiguous()
            assert views[n].data_ptr() == again[n].data_ptr() == cross[n].data_ptr()


def test_masked_whole_cache_read_equals_the_window():
    """``qkv_attention`` over the whole cache under ``position_mask``
    against the window [0, pos], with stale finite values past pos."""
    gen = torch.Generator().manual_seed(10)
    bk, ctx, h, dh = 6, 13, 2, 32
    q = torch.randn((bk, 1, h, dh), generator=gen)
    k, v = (torch.randn((bk, ctx, h, dh), generator=gen) * 3 for _ in range(2))
    for pos in (0, 4, 12):
        window = layers.qkv_attention(q, k[:, : pos + 1], v[:, : pos + 1])
        mask = dec.position_mask(torch.tensor([pos]), ctx, torch.float32)
        whole = layers.qkv_attention(q, k, v, mask)
        torch.testing.assert_close(whole, window, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv", [torch.float32, torch.float8_e4m3fn], ids=["f32", "fp8"])
def test_fused_step_at_a_tensor_position(kv):
    """``decoder_step_fused`` at a tensor position against its int form:
    the planes' windows bitwise, the logits to 1e-5."""
    params, enc = _model(11)
    bk, ctx, pos = 6, 12, 5
    xkv = dec.precompute_cross_kv(params, enc[:2], DIMS, kv_dtype=kv)
    gen = torch.Generator().manual_seed(12)
    hd = DIMS.n_text_state
    planes = {n: (torch.randn((2, DIMS.n_text_layer, bk, ctx, hd), generator=gen)).to(kv)
              for n in ("k", "v")}
    twin = {n: p.clone() for n, p in planes.items()}
    idx = torch.tensor([2, 0, 1, 5, 5, 3], dtype=torch.int32)
    tok = torch.tensor([11, 12, 13, 14, 15, 16])
    want, _ = dec.decoder_step_fused(params, tok, pos, planes, 1, idx, xkv, DIMS, beam_width=3)
    got, _ = dec.decoder_step_fused(params, tok, torch.tensor([pos]), twin, 1, idx, xkv, DIMS,
                                    beam_width=3)
    for n in ("k", "v"):
        assert torch.equal(twin[n].view(torch.uint8), planes[n].view(torch.uint8))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_rows_forward_at_one_position_equals_the_int_step():
    """Greedy's step: every row at the position held in a tensor (the
    per-row form over the whole cache) against the int step's window."""
    params, enc = _model(13)
    xkv = dec.precompute_cross_kv(params, enc, DIMS)
    cache = dec.init_kv_cache(DIMS, 3, 12)
    _, cache = dec.decoder_prefill(params, PROMPT, cache, xkv, DIMS)
    twin = {n: c.clone() for n, c in cache.items()}
    tok = torch.tensor([7, 8, 9])
    want, cache = dec.decoder_step(params, tok, 4, cache, xkv, DIMS)
    got, twin = dec._decoder_forward(params, tok[:, None], torch.tensor([4]).expand(3), twin, xkv,
                                     DIMS)
    for n in ("k", "v"):
        assert torch.equal(twin[n], cache[n])
    torch.testing.assert_close(got[:, 0], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos", [0, 3, 7])
@pytest.mark.parametrize("parity", [0, 1])
def test_k2_plain_version_at_a_tensor_position(pos, parity):
    gen = torch.Generator().manual_seed(pos)
    planes = [(torch.randn((2, 2, 5, 8, 64), generator=gen)).to(torch.float8_e4m3fn)
              for _ in range(2)]
    twin = [p.clone() for p in planes]
    idx = torch.tensor([4, 4, 0, 2, 1], dtype=torch.int32)
    new = [torch.randn((5, 64), generator=gen) for _ in range(2)]
    fused_step.permute_append(*planes, idx, 1, pos, parity, *new)
    fused_step.permute_append(*twin, idx, 1, torch.tensor([pos]), parity, *new)
    for a, b in zip(planes, twin):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_k2_refuses_a_bad_tensor_position():
    planes = [torch.zeros((2, 1, 2, 4, 16)) for _ in range(2)]
    idx = torch.arange(2, dtype=torch.int32)
    new = torch.zeros((2, 16))
    for pos in (torch.tensor([1], dtype=torch.int32), torch.tensor([1, 2]), torch.tensor([4])):
        with pytest.raises(ValueError):
            fused_step.permute_append(*planes, idx, 0, pos, 0, new, new)
    with pytest.raises(TypeError):
        fused_step.permute_append_sharded(*planes, idx, 0, torch.tensor([1]), 0, new, new, beam=2)


def test_decode_loop_span_counts_graphed_steps():
    params, enc = _model(14)
    profiling.reset_spans()
    steps0 = greedy.steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        greedy.greedy_decode(params, enc, PROMPT, DIMS, EOT, 5, graphs=graph.StepGraphs())
        beam.beam_decode(params, enc, PROMPT, DIMS, EOT, 5, beam_size=2, fused="off")
    loops = [s for s in profiling.spans() if s.name == "decode.loop"]
    profiling.reset_spans()
    assert len(loops) == 2
    assert all(s.attrs["graphed"] == 0 for s in loops)  # the CPU replays nothing
    assert loops[0].attrs["steps"] == greedy.steps - steps0


def test_engine_keeps_the_eager_loop_on_the_cpu():
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    engine = create_engine(EngineType.MONOLITH, EngineConfig(model="dev", dtype="float32"),
                           device="cpu")
    assert engine._graphs is None


def _metric(name):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, trace_id, parent=None, **attrs):
    return profiling.Span(name, 0, 1, id=trace_id * 10 + len(attrs), parent=parent,
                          trace_id=trace_id, thread=0, attrs=attrs)


@pytest.mark.parametrize("graphed, want", [((0, 0), None), ((30, 31), 100.0 * 61 / 64),
                                           ((32, 32), 100.0)])
def test_decode_graph_share_metric(graphed, want):
    """Over the batches after the first: the sum of ``graphed`` over the
    sum of ``steps``; nothing where no span carries ``graphed`` (the
    parent's program)."""
    m = _metric("decode_graph_share.offline")
    spans = []
    for t, g in enumerate((5,) + graphed):
        spans.append(_span("engine.batch", t))
        attrs = {"steps": 32} if want is None else {"steps": 32, "graphed": g}
        spans.append(_span("decode.loop", t, parent=1, **attrs))
    got = m.value(spans)
    assert got == pytest.approx(want) if want is not None else got is None
    assert (m.LAYER, m.UNIT, m.MOVES) == ("decode loop", "%", "audio_s_per_s")
