"""The cross-attention kernel (``ops/cross_attend``) against its plain
version on the card, and its launches under graph replay.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cross_attend_cuda.py

* the kernel against ``cross_attend_reference`` on the same card tensors,
  within 2 bf16 ulps of the output's largest magnitude (each rounds the
  softmax weights and the output to bf16 after sums taken in another
  order), at the shapes of ``tests/test_torch_cross_attend.py``: stored
  K/V in bf16, e4m3 and e5m2; 1, 5, 4, 20 and 17 queries a row; Tk 1500,
  375 and 1; 20 and 10 heads; then at the flagship's step [16 rows, 5
  queries, 20 heads, Tk 1500] in e4m3 and turbo's [16, 1, 20, 1500] in
  bf16, and with bases that allow only 2 or 1 keys a load; one launch a
  call;
* the refusals on the card: a bf16 call of ``layers.cross_attention_T``
  whose head size or store the kernel does not take, and a Tk whose row of
  scores does not fit a block's shared memory (the C entry's layout);
* a greedy decode at ``tiny`` width in bf16, its steps replayed from
  captured graphs: ``launches`` rises by one a layer for the prefill and
  for every step, replays included, and equals the ``cross_attend``
  kernels in a profiler trace of the decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode import graph, greedy
from whisper_tpu_torch.models.params import init_params
from whisper_tpu_torch.ops import cross_attend

pytestmark = pytest.mark.cuda

STORES = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
DIMS = dataclasses.replace(MODEL_DIMS["tiny"], n_audio_ctx=1500)
EOT, SOT = 50257, 50258


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _inputs(card, store, b, tq, h, tk, seed=0):
    gen = torch.Generator(card).manual_seed(seed)
    q = torch.randn((b, tq, h, 64), generator=gen, device=card).to(torch.bfloat16)
    kv = [(2.0 * torch.randn((b, h, 64, tk), generator=gen, device=card)).to(store) for _ in range(2)]
    return q, *kv


def _assert_close(q, kT, vT):
    before = cross_attend.launches
    got = cross_attend.cross_attend(q, kT, vT)
    torch.cuda.synchronize()
    assert cross_attend.launches == before + 1
    want = cross_attend.cross_attend_reference(q, kT, vT)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and got.is_contiguous()
    ref_max = want.float().abs().max().item()
    tol = 2.0 * 2.0 ** (np.floor(np.log2(max(ref_max, 2.0**-20))) - 7)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("tk", [1500, 375, 1])
@pytest.mark.parametrize("tq", [1, 5, 4, 20, 17])
@pytest.mark.parametrize("store", STORES)
def test_kernel_matches_plain_version(card, store, tq, tk, heads):
    _assert_close(*_inputs(card, store, 2, tq, heads, tk))


@pytest.mark.parametrize("store,tq", [(torch.float8_e4m3fn, 5), (torch.bfloat16, 1)])
def test_the_cells_steps(card, store, tq):
    _assert_close(*_inputs(card, store, 16, tq, 20, 1500, seed=1))


@pytest.mark.parametrize("offset,kpl", [(2, 2), (1, 1)])
def test_misaligned_bases(card, offset, kpl):
    """fp8 K and V that start 2 bytes or 1 byte past a 4-byte boundary:
    the plan reads 2 keys or 1 key a load."""
    q, kT, vT = _inputs(card, torch.float8_e4m3fn, 2, 5, 20, 1500, seed=2)

    def shifted(x):
        buf = torch.empty(x.numel() + 16, dtype=torch.uint8, device=card)
        view = buf[offset: offset + x.numel()].view(x.dtype).view(x.shape)
        view.copy_(x)
        return view

    k2, v2 = shifted(kT), shifted(vT)
    assert cross_attend.plan(5, 1500, 1, k2.data_ptr(), v2.data_ptr()).kpl == kpl
    _assert_close(q, k2, v2)


def test_strided_query(card):
    q, kT, vT = _inputs(card, torch.float8_e4m3fn, 2, 5, 20, 300, seed=3)
    _assert_close(q.transpose(1, 2).contiguous().transpose(1, 2), kT, vT)


def test_refusals_on_the_card(card):
    q, kT, vT = _inputs(card, torch.float8_e4m3fn, 2, 5, 20, 100)
    with pytest.raises(ValueError, match="K must be contiguous"):
        cross_attend.cross_attend(q, torch.cat([kT, kT], -1)[..., :100], vT)
    with pytest.raises(ValueError, match="bfloat16 query"):
        cross_attend.cross_attend(q.float(), kT, vT)


def test_bf16_calls_the_kernel_does_not_take_are_refused(card):
    """``layers.cross_attention_T`` sends every bf16 card call to the
    kernel: a head size or store it does not take raises, it is not read
    by the plain version."""
    from whisper_tpu_torch.models import layers

    q, kT, vT = _inputs(card, torch.bfloat16, 2, 5, 4, 100)
    with pytest.raises(ValueError, match=r"\[B, Tq, H, 64\]"):
        layers.cross_attention_T(q[..., :32].contiguous(), kT[:, :, :32].contiguous(),
                                 vT[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="K and V must both"):
        layers.cross_attention_T(q, kT.half(), vT.half())


def test_scores_past_shared_memory_are_refused(card):
    """16 queries a block keep 16 × (Tk rounded up to 64, + 69) f32 in
    shared memory: Tk 3520 fits a block's 232,448 bytes, 3521 does not."""
    q, kT, vT = _inputs(card, torch.bfloat16, 1, 20, 2, 3520, seed=4)
    _assert_close(q, kT, vT)
    q, kT, vT = _inputs(card, torch.bfloat16, 1, 20, 2, 3521, seed=4)
    before = cross_attend.launches
    with pytest.raises(ValueError, match="shared memory"):
        cross_attend.cross_attend(q, kT, vT)
    assert cross_attend.launches == before


def test_replayed_greedy_decode_counts_its_launches(card):
    from torch.profiler import ProfilerActivity, profile

    params = init_params(DIMS, torch.Generator(card).manual_seed(5), dtype=torch.bfloat16, device=card)
    gen = torch.Generator(card).manual_seed(6)
    enc = torch.randn((4, DIMS.n_audio_ctx, DIMS.n_audio_state), generator=gen, device=card)
    prompt = torch.tensor([[SOT, 50259, 50359, 50363]] * 4, device=card)
    kw = dict(dims=DIMS, eot=EOT, max_new_tokens=24, compute_dtype=torch.bfloat16)
    graphs = graph.StepGraphs()
    for traced in (False, True):
        torch.cuda.synchronize()
        launches, steps, replays = cross_attend.launches, greedy.steps, graph.replays
        if traced:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                greedy.greedy_decode(params, enc.to(torch.bfloat16), prompt, graphs=graphs, **kw)
                torch.cuda.synchronize()
        else:
            greedy.greedy_decode(params, enc.to(torch.bfloat16), prompt, graphs=graphs, **kw)
            torch.cuda.synchronize()
        n, steps, replays = (cross_attend.launches - launches, greedy.steps - steps,
                             graph.replays - replays)
        assert replays > 0
        assert n == DIMS.n_text_layer * (1 + steps), (n, steps)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name.startswith(cross_attend.KERNEL_SYMBOL)]
    assert len(names) == n
