"""The plain reference agrees with the port where they compute the same
thing, and its control (a precision below what the configuration states)
fails the cell's limits.

CPU, ``dev`` and ``tiny`` sizes. The reference imports nothing of the
program; these tests do, to hold one against the other.
"""

import json

import numpy as np
import pytest
import torch

from port_bench import run as R
from port_bench.common.frozen import make_batch
from port_bench.common.weights import make_params
from port_bench.reference import judge as J
from port_bench.reference.whisper import (
    Whisper,
    auto_audio_ctx,
    int16_grid,
    log_mel,
    quantize,
    round_e4m3,
    strict_f32,
)
from port_bench.tests.conftest import TINY

DEV = dict(TINY, program_model="dev", d_model=64, encoder_layers=2, decoder_layers=2,
           encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=256,
           decoder_ffn_dim=256)


def _sizes(base):
    return dict(base, max_target_positions=448, max_source_positions=1500)


def test_e4m3_rounding_equals_torch_cast():
    x = torch.randn(100_000) * 3
    for scale in (1e-3, 1e-2, 1.0, 50.0):
        assert torch.equal(round_e4m3(x * scale), (x * scale).to(torch.float8_e4m3fn).float())


def test_int8_equals_the_ports_quantisation():
    from whisper_tpu_torch.models.quantize import absmax_quantize

    w = torch.randn(96, 40).to(torch.bfloat16)
    q, s = absmax_quantize(w, (0,))
    assert torch.equal(quantize(w, (0,), 8), q.float() * s[None, :])


def test_log_mel_and_crop_equal_the_ports():
    from whisper_tpu_torch.engine.engine import last_content_index, snap_audio_ctx
    from whisper_tpu_torch.frontend.filters import mel_filterbank
    from whisper_tpu_torch.frontend.mel import log_mel_spectrogram

    x = int16_grid(make_batch(2, 30, seed=5))
    x[1, 123_456:] = 0
    ours = log_mel(torch.from_numpy(x), 128)
    theirs = log_mel_spectrogram(torch.from_numpy(x), torch.from_numpy(mel_filterbank(n_mels=128)),
                                 n_mels=128)
    assert (ours - theirs).abs().max() < 1e-4
    for n in (1000, 150_000, 330_000):
        z = np.zeros((2, 480_000), np.float32)
        z[0, :n] = 0.5
        assert auto_audio_ctx(z) == snap_audio_ctx(last_content_index(z), 1500)


def test_rules_equal_the_ports():
    from whisper_tpu_torch.decode.logits import make_rules
    from whisper_tpu_torch.tokenizer.vocab import Vocab

    for n_vocab, langs in ((51866, 100), (51865, 99)):
        v = Vocab.synthetic(multilingual=True, num_languages=langs)
        rules = make_rules(v, n_vocab=n_vocab)
        assert J.suppressed(n_vocab) == sorted(np.flatnonzero(rules.static_bias < 0).tolist())
        assert sorted(np.flatnonzero(rules.blank_bias < 0).tolist()) == [32, v.specials.eot]


def _served(sizes, params, audio, max_new=16, **engine):
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    cfg = EngineConfig(model=sizes["program_model"], language="en", max_new_tokens=max_new,
                       **engine)
    res = create_engine(EngineType.MONOLITH, cfg, params=params, device="cpu").transcribe_batch(audio)
    crop = auto_audio_ctx(audio)
    assert list(res[0].tokens[:4]) == J.prompt(sizes["vocab_size"])
    return [dict(audio=audio[i], crop=crop, tokens=r.tokens, length=r.length,
                 score=r.avg_logprob) for i, r in enumerate(res)]


@pytest.mark.parametrize("seed", [3, 4])
def test_f32_port_serves_the_references_tokens(seed):
    strict_f32()
    sizes = _sizes(DEV)
    params = make_params(sizes, seed, "cpu", dtype=torch.float32)
    audio = int16_grid(make_batch(3, 20, seed=seed))
    items = _served(sizes, params, audio, dtype="float32")
    out = J.judge(Whisper(params, sizes), items, sizes, 1, 16, "cpu")
    assert out["malformed"] == 0 and out["top1_gap"] < 1e-4


def _limits(cell):
    return json.loads((R.BENCH / "workloads" / f"{cell}.json").read_text())["limits"]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_flagship_within_limits_and_its_control_not(seed):
    strict_f32()
    sizes = _sizes(TINY)
    params = make_params(sizes, seed, "cpu")
    audio = int16_grid(make_batch(4, 30, seed=seed))
    items = _served(sizes, params, audio, max_new=32, dtype="bfloat16", beam_size=5,
                    quantization="int8", kv_cache_dtype="float8_e4m3fn")
    cfg = json.loads((R.BENCH / "configs" / "large-v3.flagship.json").read_text())["reference"]
    out = J.judge(Whisper(params, sizes, weights=cfg["weights"], kv=cfg["kv"]), items, sizes, 5,
                  32, "cpu", control=Whisper(params, sizes, **cfg["control"]))
    limits = _limits("large-v3.flagship.offline-30s")
    assert all(out[k] <= v for k, v in limits.items())
    assert any(out["control." + k] > v for k, v in limits.items() if k != "malformed")


def test_turbo_within_limit_and_its_control_not_on_half_the_seeds():
    """At ``tiny`` sizes a random decoder repeats itself with wide margins,
    so the control flips no token on some seeds (on the card, at the
    cell's sizes, it failed on every seed tried: PERF.md)."""
    strict_f32()
    sizes = _sizes(TINY)
    cfg = json.loads((R.BENCH / "configs" / "large-v3-turbo.greedy.json").read_text())["reference"]
    limit = _limits("large-v3-turbo.offline-30s")["top1_gap"]
    fails = 0
    for seed in range(11, 17):
        params = make_params(sizes, seed, "cpu")
        audio = int16_grid(make_batch(8, 30, seed=seed))
        items = _served(sizes, params, audio, max_new=48, dtype="bfloat16")
        out = J.judge(Whisper(params, sizes), items, sizes, 1, 48, "cpu",
                      control=Whisper(params, sizes, **cfg["control"]))
        assert out["top1_gap"] <= limit
        fails += out["control.top1_gap"] > limit
    assert fails >= 3  # half of the six seeds
