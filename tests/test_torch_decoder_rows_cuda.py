"""Per-row positions on the card: the fp8 cache write of the slot pool's
step, through byte views, against the CPU's.

Needs an NVIDIA card and the CUDA build of PyTorch; skips elsewhere.
Imports neither JAX nor the JAX package, so on the machine with the card it
runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decoder_rows_cuda.py

``scatter_rows`` and the slot moves copy bytes, so card and CPU must agree
BITWISE on them; the per-row decoder step computes in float32 (TF32 off)
and its logits agree to 1e-4 with an f32 cache; with an fp8 cache it
writes each row's position and nothing else.
"""

import dataclasses

import pytest
import torch

from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.decode import continuous as cont
from whisper_tpu_torch.models import decoder as dec
from whisper_tpu_torch.models.params import init_params, to_device

pytestmark = pytest.mark.cuda

FP8 = torch.float8_e4m3fn
DIMS = dataclasses.replace(MODEL_DIMS["tiny"], n_audio_ctx=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).cpu()


@pytest.mark.parametrize("dtype", [FP8, torch.bfloat16, torch.float32])
def test_scatter_rows_bitwise_equal_to_cpu(card, dtype):
    gen = torch.Generator().manual_seed(0)
    dst = (4 * torch.randn((8, 68, 6, 64), generator=gen)).to(dtype)
    new = 4 * torch.randn((8, 6, 64), generator=gen)
    pos = torch.tensor([0, 67, 5, 5, 30, 1, 66, 12])
    on_card = dst.to(card)
    dec.scatter_rows(on_card, pos.to(card), new.to(card))
    dec.scatter_rows(dst, pos, new)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(on_card), _bytes(dst))


def test_slot_moves_bitwise_equal_to_cpu(card):
    """insert_slot and move_slot on an fp8 pool: byte copies, the same on
    the card as on the CPU."""
    gen = torch.Generator().manual_seed(1)
    state = cont.init_slot_state(DIMS, 4, 12, 50257, kv_dtype=FP8, device="cpu")
    for tree in (state.cache, state.cross_kv):
        for n in ("k", "v"):
            tree[n].copy_(torch.randn(tree[n].shape, generator=gen).to(FP8))
    state.tokens.copy_(torch.randint(0, 50000, state.tokens.shape, generator=gen))
    pack = cont.SlotPack(
        tokens=torch.randint(0, 50000, (2, 12), generator=gen),
        pos=torch.tensor([5, 6]),
        still_active=torch.tensor([True, False]),
        cache={n: torch.randn(x[:, :2].shape, generator=gen).to(FP8) for n, x in state.cache.items()},
        cross_kv={n: torch.randn(x[:, :2].shape, generator=gen).to(FP8) for n, x in state.cross_kv.items()},
    )
    on_card = cont.SlotState(
        state.tokens.to(card), state.pos.to(card), state.active.to(card),
        {n: x.to(card) for n, x in state.cache.items()}, {n: x.to(card) for n, x in state.cross_kv.items()},
    )
    card_pack = cont.pack_to(pack, card)
    for s, p in ((state, pack), (on_card, card_pack)):
        cont.insert_slot(s, 3, p, 0)
        cont.insert_slot(s, 1, p, 1)
        cont.move_slot(s, 3, 0)
    torch.cuda.synchronize()
    for a, b in zip((state.tokens, state.pos, state.active), (on_card.tokens, on_card.pos, on_card.active)):
        assert torch.equal(a, b.cpu())
    for n in ("k", "v"):
        assert torch.equal(_bytes(on_card.cache[n]), _bytes(state.cache[n]))
        assert torch.equal(_bytes(on_card.cross_kv[n]), _bytes(state.cross_kv[n]))


def _prefilled(device, kv):
    params = to_device(init_params(DIMS, torch.Generator().manual_seed(2)), device)
    enc = torch.randn((3, 64, DIMS.n_audio_state), generator=torch.Generator().manual_seed(3)).to(device)
    prompt = torch.tensor([[50258, 50259, 50359, 50363]] * 3, device=device)
    xkv = dec.precompute_cross_kv(params, enc, DIMS, kv_dtype=kv)
    cache = dec.init_kv_cache(DIMS, 3, 12, dtype=kv or torch.float32, device=device)
    _, cache = dec.decoder_prefill(params, prompt, cache, xkv, DIMS)
    return params, xkv, cache


STEPS = (([4, 4, 4], [11, 12, 13]), ([5, 4, 6], [400, 7, 9]), ([6, 5, 7], [3, 3, 501]))


def test_decoder_step_rows_close_to_cpu(card):
    """f32 cache: the per-row steps' logits on the card within 1e-4 of the
    CPU's (f32 sums in another order, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for device in ("cpu", card):
        params, xkv, cache = _prefilled(device, None)
        logits = []
        for pos, tok in STEPS:
            lg, cache = dec.decoder_step(params, torch.tensor(tok, device=device), torch.tensor(pos, device=device),
                                         cache, xkv, DIMS)
            logits.append(lg.cpu())
        out.append(logits)
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def test_decoder_step_rows_fp8_writes_only_each_rows_position(card):
    """fp8 cache on the card: each per-row step changes the cache only at
    (row, pos[row]), and its logits are finite. (Card and CPU compute the
    new K/V rows in f32 in another order, so their fp8 bytes may differ by
    a rounding step: the fp8 pool is held against the CPU by tokens, in
    chip_smoke.py phase 5.)"""
    params, xkv, cache = _prefilled(card, FP8)
    for pos, tok in STEPS:
        before = {n: _bytes(cache[n]) for n in ("k", "v")}
        lg, cache = dec.decoder_step(params, torch.tensor(tok, device=card), torch.tensor(pos, device=card),
                                     cache, xkv, DIMS)
        assert bool(torch.isfinite(lg).all())
        for n in ("k", "v"):
            after = _bytes(cache[n])
            changed = (after != before[n]).flatten(3).any(-1)  # [L, B, ctx]
            allowed = torch.zeros_like(changed)
            for b, p in enumerate(pos):
                allowed[:, b, p] = True
            assert not bool((changed & ~allowed).any())
