"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU (the look for a card is
skipped: ``run.execute`` is called directly) at ``tiny`` sizes, with one
fault planted in the program's decode:

* ``token``: a token altered where it is produced (the greedy pick, the
  slot pool's pick, or a beam candidate);
* ``state``: a decode step that leaves its KV cache unchanged;
* ``half``: half of the batch's results left out (offline), or every
  other request never answered (serving).

A sound run of the same cell and seed is correct. (The fourth fault of
the contract, the exchange between chips left out, cannot occur: every
cell runs on one card.)
"""

import itertools

import pytest

from port_bench import run as R
from port_bench.tests.conftest import TINY

CELLS = {
    "large-v3.flagship.offline-30s": {"rows": 2, "max_new_tokens": 8, "pool": 1,
                                      "judge_requests": 2},
    "large-v3-turbo.offline-30s": {"rows": 4, "max_new_tokens": 32, "pool": 1,
                                   "judge_requests": 4},
    "large-v3-turbo.serve-poisson": {"n_slots": 4, "prefill_batch": 2, "rate_per_s": 1.5,
                                     "max_new_tokens": 12, "warm_requests": 1,
                                     "judge_requests": 3, "drain_timeout_s": 30.0},
}
SEED = 20240611


def _cell_run(cell, seconds=2.0):
    run = R.prepare(cell, SEED, "cpu", {"config": TINY, "traffic": CELLS[cell]})
    run.log = lambda msg: None
    return R.execute(run, seconds, False)


def _plant(monkeypatch, cell: str, fault: str) -> None:
    from whisper_tpu_torch.decode import beam, continuous, greedy
    from whisper_tpu_torch.engine import engine as engine_mod
    from whisper_tpu_torch.engine import serving

    calls = itertools.count()
    if fault == "token":
        if "flagship" in cell:
            real = beam.topk_wide

            def altered(x, k):
                vals, idx = real(x, k)
                if next(calls) % 5 == 3:
                    idx = (idx + 17) % x.shape[-1]
                return vals, idx

            monkeypatch.setattr(beam, "topk_wide", altered)
        else:
            mod = continuous if "serve" in cell else greedy
            real = mod.argmax_last

            def altered(logits, dim=-1):
                out = real(logits, dim)
                return (out + 17) % logits.shape[-1] if next(calls) % 5 == 3 else out

            monkeypatch.setattr(mod, "argmax_last", altered)
    elif fault == "state":
        mod = beam if "flagship" in cell else continuous if "serve" in cell else greedy
        real = mod.decoder_step

        def stale(params, tok, pos, cache, *a, **kw):
            logits, _ = real(params, tok, pos, {k: v.clone() for k, v in cache.items()}, *a, **kw)
            return logits, cache

        monkeypatch.setattr(mod, "decoder_step", stale)
    elif fault == "half":
        if "serve" in cell:
            from concurrent.futures import Future

            real = serving.ContinuousTranscriber.submit

            def drop(self, samples):
                return real(self, samples) if next(calls) % 2 == 0 else Future()

            monkeypatch.setattr(serving.ContinuousTranscriber, "submit", drop)
        else:
            real = engine_mod.Monolith.transcribe_batch

            def half(self, samples, *a, **kw):
                out = real(self, samples, *a, **kw)
                return out[: len(out) // 2] if next(calls) >= 1 else out  # the warm-up is whole

            monkeypatch.setattr(engine_mod.Monolith, "transcribe_batch", half)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    res = _cell_run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["token", "state", "half"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, cell, fault)
    res = _cell_run(cell)
    assert not res["correct"], res["checks"]
