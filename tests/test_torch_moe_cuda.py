"""The routed experts' kernels (``ops/moe_expert.py``) and the audio LM's
captured decode step on the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_cuda.py

* the two kernels (``csrc/moe_expert.cu``) against the plain version at Uni-MoE-2.0-Omni's
  published widths (d 3584, f 18944, 4 experts), with 1, 20 and 4,000 rows
  an expert and one expert given no rows;
* a decode replayed as a CUDA graph gives the eager loop's tokens, lengths
  and routing counts, bitwise (both read the same windows), at the
  published widths with two layers;
* ``torch.cuda.set_sync_debug_mode("error")`` raises nothing in the
  prefill or in a replayed step.
"""

import dataclasses

import pytest
import torch

from whisper_tpu_torch.config import AUDIO_LM_DIMS
from whisper_tpu_torch.decode import graph, greedy
from whisper_tpu_torch.models import audio_lm
from whisper_tpu_torch.ops import moe_expert

pytestmark = pytest.mark.cuda

FULL = AUDIO_LM_DIMS["uni-moe-2.0-omni"]
# Two layers at the published widths; the tower of the CPU tests (the step
# does not read it).
TWO = dataclasses.replace(FULL, n_layer=2, tower=AUDIO_LM_DIMS["uni-moe-dev"].tower)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are tuned for sm_90")
    return torch.device("cuda", 0)


def _experts(card, gen, e=4, d=FULL.n_state, f=FULL.routed_width):
    def w(shape, fan):
        return (torch.randn(shape, generator=gen, device=card) * fan ** -0.5).to(torch.bfloat16)

    return w((e, d, f), d), w((e, d, f), d), w((e, f, d), f)


@pytest.mark.parametrize("rows", [1, 20, 4000])
def test_kernel_against_plain_version(card, rows):
    """Experts 0-2 get ``rows`` pairs each, expert 3 none; the pairs are
    spread over tokens of two slots, a slot past them routes nowhere."""
    gen = torch.Generator(card).manual_seed(rows)
    wg, wu, wd = _experts(card, gen)
    e = wg.shape[0]
    n = (3 * rows + 1) // 2
    pair = torch.arange(2 * n, device=card)
    expert = torch.where(pair < 3 * rows, pair % 3, e).view(n, 2)
    weight = torch.rand((n, 2), generator=gen, device=card)
    x = torch.randn((n, FULL.n_state), generator=gen, device=card).to(torch.bfloat16)
    before = moe_expert.launches
    y, counts = moe_expert.moe_experts(x, expert, weight, wg, wu, wd)
    torch.cuda.synchronize()
    assert moe_expert.launches == before + 2
    y_ref, counts_ref = moe_expert.moe_experts_reference(x, expert, weight, wg, wu, wd)
    assert counts.tolist() == counts_ref.tolist() == [rows, rows, rows, 0]
    # Both round the SwiGLU activations to bf16; an activation whose f32
    # value lies within the sums' reordering of a rounding boundary rounds
    # one step apart (2^-8 relative). Such steps, few and of either sign,
    # move y by far less than 1% of its RMS; the f32 sums' order alone by
    # ~1e-6 of it.
    err = (y - y_ref).abs().max() / y_ref.pow(2).mean().sqrt()
    assert float(err) < 1e-2, float(err)
    # Rows routed nowhere get nothing.
    routed = (expert < e).any(1)
    assert bool((y[~routed] == 0).all())


def _model(card, seed: int, b: int = 8, p: int = 40):
    gen = torch.Generator(card).manual_seed(seed)
    params = audio_lm.init_lm_params(TWO, gen, dtype=torch.bfloat16, device=card)
    x = (torch.randn((b, p, TWO.n_state), generator=gen, device=card)).to(torch.bfloat16)
    pad = torch.randint(0, p - 4, (b,), generator=gen, device=card)
    pad[0] = 0
    return params, x, pad


def test_graph_replay_equals_eager(card):
    params, x, pad = _model(card, 5)
    outs = []
    for graphs in (None, graph.StepGraphs()):
        counters = audio_lm.new_counters(TWO, card)
        before = graph.replays
        tokens, lengths = greedy.lm_greedy_decode(params, x, pad, TWO, 40, counters, graphs)
        torch.cuda.synchronize()
        outs.append((tokens.cpu(), lengths.cpu(), counters.cpu()))
        if graphs is not None:
            assert graph.replays - before == 40 - 1 - graph.WARM_STEPS
    (t0, l0, c0), (t1, l1, c1) = outs
    assert torch.equal(t0, t1) and torch.equal(l0, l1) and torch.equal(c0, c1)
    assert int(c0[audio_lm.STEP, -1]) == 39 * TWO.n_layer  # every step's calls counted


def test_no_sync_in_prefill_or_replayed_step(card):
    params, x, pad = _model(card, 6)
    b, p, _ = x.shape
    counters = audio_lm.new_counters(TWO, card)
    graphs = graph.StepGraphs()
    greedy.lm_greedy_decode(params, x, pad, TWO, 8, counters, graphs)  # warm: captures
    entry = next(iter(graphs._entries.values()))
    st = entry.buffers
    run = greedy._lm_graph_step(params, st, TWO, p, counters)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        audio_lm.prefill(params, x, pad, st.cache, TWO, counters)
        st.pos.fill_(p)
        assert entry.step(run, graph.window(p, p + 8))  # a replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
