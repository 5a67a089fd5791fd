"""The port's utils/profiling.py against whisper_tpu's: the same records
give the same StageTimer summary and Throughput counters; the DEBUG dump,
the torch.profiler trace and the annotations run on the CPU; the engine
records its stages and counters where JAX's does."""

import logging

import numpy as np
import pytest
import torch

from whisper_tpu.utils import profiling as jprof
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EncDec, Monolith
from whisper_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

RECORDS = [("mel", 0.012), ("model", 0.25), ("model", 0.125), ("mel", 0.0), ("encode", 1.5)]
ADDS = [(4.0, 17, 1, 0.5), (120.0, 300, 4, 2.25), (0.0, 0, 0, 0.0), (30.0, 64, 1, 0.125)]


def test_stage_timer_equal_to_jax():
    j, t = jprof.StageTimer(), tprof.StageTimer()
    for name, s in RECORDS:
        j.record(name, s)
        t.record(name, s)
    assert t.as_dict() == j.as_dict()
    assert {k: (v.count, v.total_s, v.last_s, v.mean_s) for k, v in t.summary().items()} == {
        k: (v.count, v.total_s, v.last_s, v.mean_s) for k, v in j.summary().items()
    }
    with t.stage("ctx"):
        pass
    assert t.summary()["ctx"].count == 1 and t.summary()["ctx"].last_s >= 0
    t.reset()
    assert t.as_dict() == {}


@pytest.mark.parametrize("n", [0, 1, len(ADDS)])
def test_throughput_equal_to_jax(n):
    j, t = jprof.Throughput(), tprof.Throughput()
    for a in ADDS[:n]:
        j.add(*a)
        t.add(*a)
    assert t.as_dict() == j.as_dict()
    assert (t.audio_seconds_per_s, t.tokens_per_s, t.rtf) == (j.audio_seconds_per_s, j.tokens_per_s, j.rtf)


def test_debug_dump(monkeypatch, caplog):
    monkeypatch.delenv("DEBUG", raising=False)
    assert not tprof.debug_enabled()
    with caplog.at_level(logging.INFO, logger="whisper_tpu_torch"):
        tprof.debug_dump("off", np.zeros(3))
        monkeypatch.setenv("DEBUG", "1")
        tprof.debug_dump("arr", np.arange(10, dtype=np.float32))
        tprof.debug_dump("tensor", torch.arange(4, dtype=torch.bfloat16))
    text = caplog.text
    assert "off" not in text
    assert "DEBUG arr: shape=(10,) dtype=float32" in text
    assert "DEBUG tensor: shape=(4,)" in text


def test_trace_and_annotate_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("region"):
            torch.ones(8).sum()
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize("cls", [Monolith, EncDec])
def test_engine_records_stages_and_throughput(cls):
    cfg = EngineConfig(model="dev", language="en", dtype="float32", max_new_tokens=3)
    eng = cls.from_random(cfg, seed=0, device="cpu")
    x = np.zeros((3, 16_000 * 2), np.float32)
    x[:, :100] = 0.1
    results = eng.transcribe_batch(x)
    stages = eng.timer.summary()
    assert stages["model"].count == 1
    assert ("mel" in stages) == (cls is EncDec)
    tp = eng.throughput
    assert tp.utterances == 3 and tp.audio_seconds == pytest.approx(6.0)
    assert tp.tokens == sum(r.length for r in results)
    want_ms = (results[0].mel_ms or 0.0) + results[0].model_ms
    assert tp.wall_s == pytest.approx(want_ms / 1e3)
