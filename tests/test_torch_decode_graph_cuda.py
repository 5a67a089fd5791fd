"""Decode steps captured as CUDA graphs and replayed (``decode/graph.py``),
on the card, against the eager loops there; K2's device-position entry
against its plain version.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_graph_cuda.py

* greedy in bfloat16 and the flagship's beam (int8 weights, an fp8 KV
  cache, "hybrid") at ``tiny`` width, replayed, give the eager loop's
  tokens and lengths on the card;
* K2 reading its position on the card moves the bytes its plain version
  moves, BITWISE, at several positions and both parities, launched
  directly and replayed from one captured graph while the position
  advances;
* two cross-K/V crops in turns share one set of buffers and give the
  eager loop's tokens, greedy and beam;
* K2's kernels in a profiler trace of a replayed beam decode are one
  per layer and step, as its ``launches`` counts them;
* over two batches of one shape, ``decode.graph.captures`` counts one
  capture per variant in the first batch and none in the second (greedy:
  one per read window, 1 at a 20-position cache; beam: one per window and
  read-plane parity, 2), ``decode.graph.replays`` every step after the
  warm-up ones, and K2's ``launches`` one per layer and step, replays
  included.
"""

import dataclasses

import pytest
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode import beam, graph, greedy
from whisper_tpu_torch.models.params import init_params
from whisper_tpu_torch.models.quantize import quantize_params
from whisper_tpu_torch.ops import fused_step as tf

pytestmark = pytest.mark.cuda

DIMS = dataclasses.replace(MODEL_DIMS["tiny"], n_audio_ctx=200)
EOT, SOT = 50257, 50258
FP8 = torch.float8_e4m3fn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _model(card, seed, b=4, dtype=torch.bfloat16):
    params = init_params(DIMS, torch.Generator(card).manual_seed(seed), dtype=dtype, device=card)
    gen = torch.Generator(card).manual_seed(seed + 1)
    enc = torch.randn((b, DIMS.n_audio_ctx, DIMS.n_audio_state), generator=gen, device=card)
    prompt = torch.tensor([[SOT, 50259, 50359, 50363]] * b, device=card)
    return params, enc.to(dtype), prompt


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_replayed_equals_eager(card, seed):
    params, enc, prompt = _model(card, seed)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=40, compute_dtype=torch.bfloat16)
    graphs = graph.StepGraphs()
    replays0 = graph.replays
    for batch in range(2):
        want = greedy.greedy_decode(params, enc, prompt, **kw)
        got = greedy.greedy_decode(params, enc, prompt, graphs=graphs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), batch
    assert graph.replays > replays0


@pytest.mark.parametrize("seed", [2, 3])
def test_flagship_beam_replayed_equals_eager(card, seed):
    params, enc, prompt = _model(card, seed)
    params = quantize_params(params)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=36, beam_size=5, compute_dtype=torch.bfloat16,
              kv_cache_dtype=FP8, fused="hybrid")
    graphs = graph.StepGraphs()
    for batch in range(2):
        want = beam.beam_decode(params, enc, prompt, **kw)
        got = beam.beam_decode(params, enc, prompt, graphs=graphs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), batch
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-3)


def _planes(card, seed, bk=10, ctx=40, hd=384):
    gen = torch.Generator(card).manual_seed(seed)
    planes = [torch.randn((2, 3, bk, ctx, hd), generator=gen, device=card).to(FP8)
              for _ in range(2)]
    idx = torch.randint(0, bk, (bk,), generator=gen, device=card, dtype=torch.int32)
    rows = [torch.randn((bk, hd), generator=gen, device=card).to(torch.bfloat16) for _ in range(2)]
    return planes, idx, rows


def _bytes(t):
    return t.view(torch.uint8).cpu()


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("pos", [0, 1, 17, 39])
def test_k2_device_position_bitwise(card, pos, parity):
    planes, idx, rows = _planes(card, pos * 2 + parity)
    ref = [p.cpu() for p in planes]
    tf.permute_append(*planes, idx, 1, torch.tensor([pos], device=card), parity, *rows)
    tf.permute_append_reference(*ref, idx.cpu(), 1, pos, parity, *(r.cpu() for r in rows))
    torch.cuda.synchronize()
    for a, b in zip(planes, ref):
        assert torch.equal(_bytes(a), b.view(torch.uint8))


@pytest.mark.parametrize("parity", [0, 1])
def test_k2_device_position_replayed(card, parity):
    """One captured launch, replayed while the position advances: each
    replay's bytes equal the plain version's at that position."""
    planes, idx, rows = _planes(card, 50 + parity)
    ref = [p.cpu() for p in planes]
    pos = torch.zeros((1,), dtype=torch.int64, device=card)
    launches = tf.launches
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        tf.permute_append(*planes, idx, 2, pos, parity, *rows)
    for p in (3, 4, 20, 39):
        pos.fill_(p)
        g.replay()
        tf.permute_append_reference(*ref, idx.cpu(), 2, p, parity, *(r.cpu() for r in rows))
        torch.cuda.synchronize()
        for a, b in zip(planes, ref):
            assert torch.equal(_bytes(a), b.view(torch.uint8)), p
    assert tf.launches == launches + 1  # the capture's one launch (replays not counted here)


def test_captures_and_replays_counted(card):
    params, enc, prompt = _model(card, 4)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=16, compute_dtype=torch.bfloat16)
    graphs = graph.StepGraphs()
    c0, r0, s0 = graph.captures, graph.replays, greedy.steps
    greedy.greedy_decode(params, enc, prompt, graphs=graphs, **kw)
    assert graph.captures - c0 == 1
    greedy.greedy_decode(params, enc, prompt, graphs=graphs, **kw)
    torch.cuda.synchronize()
    assert graph.captures - c0 == 1
    assert graph.replays - r0 == greedy.steps - s0 - graph.WARM_STEPS

    params = quantize_params(params)
    kw.update(beam_size=3, kv_cache_dtype=FP8, fused="hybrid")
    c0, r0, s0, k0 = graph.captures, graph.replays, beam.steps, tf.launches
    beam.beam_decode(params, enc, prompt, graphs=graphs, **kw)
    assert graph.captures - c0 == 2
    beam.beam_decode(params, enc, prompt, graphs=graphs, **kw)
    torch.cuda.synchronize()
    assert graph.captures - c0 == 2
    assert graph.replays - r0 == beam.steps - s0 - graph.WARM_STEPS
    assert tf.launches - k0 == DIMS.n_text_layer * (beam.steps - s0)


def test_k2_replays_counted_on_the_card(card):
    """K2's kernels in a profiler trace of a decode whose steps are all
    replays: one per layer and step, as ``launches`` counts them."""
    from torch.profiler import ProfilerActivity, profile

    params, enc, prompt = _model(card, 5)
    params = quantize_params(params)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=24, beam_size=3, compute_dtype=torch.bfloat16,
              kv_cache_dtype=FP8, fused="hybrid")
    graphs = graph.StepGraphs()
    beam.beam_decode(params, enc, prompt, graphs=graphs, **kw)  # warm-up steps and captures
    torch.cuda.synchronize()
    s0, r0, k0 = beam.steps, graph.replays, tf.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        beam.beam_decode(params, enc, prompt, graphs=graphs, **kw)
        torch.cuda.synchronize()
    steps = beam.steps - s0
    on_card = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and tf.KERNEL_SYMBOL in e.name)
    assert steps > 0 and graph.replays - r0 == steps
    assert on_card == DIMS.n_text_layer * steps == tf.launches - k0


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_crops_share_buffers_on_the_card(card, mode):
    """Two cross-K/V crops in turns, over one set of buffers and one
    memory pool: every replayed decode gives the eager loop's tokens."""
    params, enc, prompt = _model(card, 6)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=40, compute_dtype=torch.bfloat16)
    run = greedy.greedy_decode
    if mode == "beam":
        params = quantize_params(params)
        kw.update(max_new_tokens=36, beam_size=5, kv_cache_dtype=FP8, fused="hybrid")
        run = beam.beam_decode
    graphs = graph.StepGraphs()
    r0 = graph.replays
    for _ in range(2):
        for x in (enc, enc[:, :96]):
            want = run(params, x, prompt, **kw)
            got = run(params, x, prompt, graphs=graphs, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), x.shape
    assert len(graphs) == 2 and len(graphs._buffers) == 1 and graph.replays > r0

