"""whisper_tpu_torch.utils.bench_serving against ``tools/bench_serving.py`` on
the CPU at ``dev`` dims.

The tool runs through its own ``main`` (``runpy``, not edited) with
``--model dev --n 4 --slots 2 --prefill-batch 2 --max-new 6 --eot-bias
2.0``: its engine factory is wrapped to record the config, and each of
its three front-end classes is replaced by a subclass that records the
futures of its submits, so the tokens of every utterance through every
front-end are read. The port's ``run`` gets the same flags and an
``EncDec`` on the same weights (``params_from_jax`` of ``init_params`` at
seed 0, what the tool's ``create_engine(seed=0)`` draws). Checked: the
utterances are the tool's; each front-end's tokens per utterance equal
the tool's same front-end; ``--eot-bias`` sets the same ``logit_bias``;
the records carry the tool's keys, in the tool's order of front-ends.
"""

import contextlib
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.engine as jax_engine_pkg
import whisper_tpu.engine.serving as jax_serving
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.utils import bench_serving

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_serving.py")
FLAGS = dict(model="dev", n=4, slots=2, prefill_batch=2, max_new=6, eot_bias=2.0)
ARGV = ["--model", "dev", "--n", "4", "--slots", "2", "--prefill-batch", "2", "--max-new", "6",
        "--eot-bias", "2.0"]
CLASSES = {"async": "AsyncTranscriber", "continuous": "ContinuousTranscriber",
           "disaggregated": "DisaggregatedTranscriber"}


def _recording(cls, seen: list):
    class Recording(cls):
        def submit(self, samples):
            fut = super().submit(samples)
            seen.append((np.array(samples), fut))
            return fut

    return Recording


@pytest.fixture(scope="module")
def tool():
    """The tool's run: its config, utterances and results per front-end
    (the timed utterances, in submit order), and its JSON lines."""
    seen = {name: [] for name in CLASSES}
    out = {}
    real_create = jax_engine_pkg.create_engine

    def create(kind, config, **kw):
        out["config"] = config
        return real_create(kind, config, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["bench_serving.py", *ARGV])
        mp.setattr(jax_engine_pkg, "create_engine", create)
        for name, cls in CLASSES.items():
            mp.setattr(jax_serving, cls, _recording(getattr(jax_serving, cls), seen[name]))
        g = runpy.run_path(TOOL, run_name="bench_serving_under_test")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert g["main"]() == 0
    out["lines"] = [json.loads(line) for line in text.getvalue().strip().splitlines()]
    # Each front-end's first submit is its warm-up transcribe; the timed run follows.
    out["utts"] = [u for u, _ in seen["continuous"][1:]]
    out["results"] = {name: [f.result(timeout=60) for _, f in calls[1:]] for name, calls in seen.items()}
    return out


@pytest.fixture(scope="module")
def port(tool):
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(model="dev").dims(), jax.random.PRNGKey(0),
                                                    dtype=jnp.float32))
    config = bench_serving.serving_config("dev", "en", "float32", FLAGS["max_new"], FLAGS["eot_bias"])
    engine = create_engine(EngineType.ENCDEC, config, params=params_from_jax(tree), device="cpu")
    return bench_serving.run(**FLAGS, engine=engine)


def test_utterances_are_the_tool_s(tool):
    ours = bench_serving.utterances(FLAGS["n"])
    assert len(ours) == len(tool["utts"]) == FLAGS["n"]
    for a, b in zip(ours, tool["utts"]):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_eot_bias_sets_the_same_logit_bias(tool):
    config = bench_serving.serving_config("dev", "en", "float32", 6, 2.0)
    assert config.logit_bias == tool["config"].logit_bias and config.logit_bias is not None
    assert config.audio_ctx is None and tool["config"].audio_ctx is None
    assert bench_serving.serving_config().logit_bias is None


@pytest.mark.parametrize("name", list(CLASSES))
def test_frontend_tokens_equal_the_tool_s(tool, port, name):
    ours, theirs = port[name]["results"], tool["results"][name]
    assert len(ours) == len(theirs) == FLAGS["n"]
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.length == b.length, (name, i)
        assert np.array_equal(np.asarray(a.tokens)[: a.length], np.asarray(b.tokens)[: b.length]), (name, i)
    # A prefill or flush per dispatch, counted: K1 is the plain version on the CPU.
    assert port[name]["dispatches"] > 0 and port[name]["k1_launches"] == 0


def test_records_carry_the_tool_s_keys(tool, port):
    lines = tool["lines"]
    assert [line.get("frontend") for line in lines[:3]] == list(CLASSES)
    for line in lines[:3]:
        rec = port[line["frontend"]]["record"]
        assert set(rec) == set(line) | {"device", "card"}
        assert rec["utterances"] == FLAGS["n"] and rec["device"] == "cpu" and rec["card"] is None
        assert rec["decode_len_minmax"] == line["decode_len_minmax"]
        assert rec["decode_len_mean"] == pytest.approx(line["decode_len_mean"], abs=0.05)
    assert set(lines[3]) == {"speedup_disagg_vs_continuous"} and port["speedup_disagg_vs_continuous"] > 0


def test_skips_and_refusals(tool):
    config = bench_serving.serving_config("dev", "en", "float32", 2)
    engine = create_engine(EngineType.ENCDEC, config, device="cpu")
    out = bench_serving.run("dev", 2, 2, 2, 2, skip_async=True, skip_disagg=True, engine=engine)
    assert list(out) == ["continuous"]
    with pytest.raises(ValueError, match="config"):
        bench_serving.run("dev", 2, 2, 2, 3, engine=engine)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_serving.run("dev", 1)
