"""whisper_tpu_torch.utils.bench against ``bench.py`` on the CPU at ``dev`` dims.

``bench.py`` runs through its own ``main`` (loaded with ``runpy``, not
edited) under ``BENCH_*`` variables for two cases: f32 greedy, and f32
beam 3 with int8 weights and the fp8 KV cache (batch 2, 8 tokens, 1
repeat). Its compile-cache setting is pointed at ``tmp_path`` and restored
afterwards, so the run leaves no file in the repo. Its engine
(``create_engine``) and ``utilization`` are wrapped to record the batches,
results and roofline arguments, and its JSON line is read from stdout. The
port's ``run`` gets an engine on the same weights (``params_from_jax`` of
``init_params`` at seed 0, what JAX's ``create_engine(seed=0)`` draws).
Checked:

* the port's synthetic batch is bitwise the batch every JAX call received;
* the port's last pipelined batch's tokens equal JAX's;
* ``tokens_decoded`` and every ``config`` field both records share are
  equal, but the measured times and the device's name;
* the port's ``utilization`` on JAX's arguments equals JAX's ``roofline``;
* the record's keys are bench.py's, less ``vs_baseline`` and
  ``config.baseline``, with ``config.card`` added;
* ``knobs`` parses the environment as bench.py does.
"""

import contextlib
import io
import json
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.engine as jax_engine_pkg
import whisper_tpu.utils.roofline as jax_roofline
from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.utils import bench
from whisper_tpu_torch.utils import roofline as port_roofline

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
COMMON = {"BENCH_MODEL": "dev", "BENCH_BATCH": "2", "BENCH_MAX_NEW": "8", "BENCH_REPEATS": "1",
          "BENCH_DTYPE": "float32"}
CASES = {
    "greedy": {"BENCH_BEAM": "1", "BENCH_QUANT": "none", "BENCH_KV": "none"},
    "beam3_int8_fp8": {"BENCH_BEAM": "3", "BENCH_QUANT": "int8", "BENCH_KV": "float8_e4m3fn"},
}
MEASURED = {"times_s", "serialized_median_s", "serialized_min_s", "pipelined_s_per_batch", "device"}


def _run_bench_py(env: dict, cache_dir: str) -> dict:
    """bench.py's ``main`` under ``env``; returns its JSON record, the
    batches its engine received, its results and the roofline call."""
    seen = {"batches": [], "results": None, "roofline": None, "cache_dir": None}
    real_create, real_util, real_update = (jax_engine_pkg.create_engine, jax_roofline.utilization,
                                          jax.config.update)
    kept = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}

    def create(*args, **kw):
        engine = real_create(*args, **kw)
        seen["config"] = args[1]
        batch_one, batches = engine.transcribe_batch, engine.transcribe_batches

        def one(x, *a, **k):
            seen["batches"].append(np.array(x))
            return batch_one(x, *a, **k)

        def many(xs, *a, **k):
            seen["batches"].extend(np.array(x) for x in xs)
            seen["results"] = batches(xs, *a, **k)
            return seen["results"]

        engine.transcribe_batch, engine.transcribe_batches = one, many
        return engine

    def utilization(*args, **kw):
        out = real_util(*args, **kw)
        seen["roofline"] = (args, kw, out)
        return out

    def update(name, value):
        if name == "jax_compilation_cache_dir":
            seen["cache_dir"], value = value, cache_dir
        real_update(name, value)

    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(jax_engine_pkg, "create_engine", create)
        mp.setattr(jax_roofline, "utilization", utilization)
        mp.setattr(jax.config, "update", update)
        g = runpy.run_path(BENCH_PY, run_name="bench_under_test")
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                g["main"]()
        finally:
            for k, v in kept.items():
                real_update(k, v)
    seen["record"] = json.loads(out.getvalue().strip().splitlines()[-1])
    seen["globals"] = g
    return seen


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    name = request.param
    env = {**COMMON, **CASES[name]}
    cache_dir = str(tmp_path_factory.mktemp("bench_jax_cache"))
    repo_cache = os.path.join(REPO, ".jax_cache")
    had_cache = os.path.exists(repo_cache)
    ref = _run_bench_py(env, cache_dir)
    assert os.path.exists(repo_cache) == had_cache  # nothing written at the repo root
    assert ref["cache_dir"] == repo_cache  # what bench.py asked for, redirected
    knobs = bench.knobs(env)
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(model="dev").dims(), jax.random.PRNGKey(0),
                                                    dtype=jnp.float32))
    config = bench.bench_config(knobs["model"], knobs["beam"], knobs["max_new"], knobs["dtype"],
                                knobs["lang"], knobs["quant"], knobs["kv_dtype"], knobs["ctx_bucket"],
                                knobs["fused"], knobs["audio_ctx"])
    engine = create_engine(EngineType.MONOLITH, config, params=params_from_jax(tree), device="cpu")
    record, results = bench.run(**knobs, engine=engine)
    return name, ref, json.loads(json.dumps(record)), results


def test_batch_is_bench_py_s(case):
    _, ref, record, _ = case
    batch = bench.make_batch(2, 30.0)
    assert batch.dtype == np.float32 and batch.shape == (2, 480_000)
    # warm-up, 1 serialized, 3 pipelined
    assert len(ref["batches"]) == 5 and all(np.array_equal(b, batch) for b in ref["batches"])


def test_last_batch_tokens_equal_jax(case):
    _, ref, record, results = case
    want = ref["results"][-1]
    assert len(results) == len(want) == 2
    for got, exp in zip(results, want):
        assert got.length == exp.length
        assert np.array_equal(np.asarray(got.tokens), np.asarray(exp.tokens))
    assert record["config"]["tokens_decoded"] == ref["record"]["config"]["tokens_decoded"]


def test_shared_config_fields_equal(case):
    _, ref, record, _ = case
    ours, theirs = record["config"], ref["record"]["config"]
    shared = (set(ours) & set(theirs)) - MEASURED
    assert {"model", "beam", "quant", "kv_dtype", "ctx_bucket", "fused_step", "audio_ctx_resolved"} <= shared
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["device"] == "cpu" and ours["card"] is None
    assert record["value_basis"] in ("pipelined", "serialized_median") and record["value"] > 0


def test_roofline_equals_jax_on_its_arguments(case):
    _, ref, record, _ = case
    args, kw, want = ref["roofline"]
    assert args[0] == JaxConfig(model="dev").dims()
    got = port_roofline.utilization(MODEL_DIMS["dev"], *args[1:], **kw)
    assert got == want
    # The same on the card's name, where the port's table has the H100 (JAX's has TPUs only).
    on_card = port_roofline.utilization(MODEL_DIMS["dev"], *args[1:], **{**kw, "device_kind": "NVIDIA H100 80GB HBM3"})
    assert on_card["chip"] == "H100 SXM" and {"mfu", "hbm_utilization", "sol_decode_s"} <= set(on_card)
    # The port's own record: the wall-independent numbers equal JAX's, no card on the CPU.
    for key in ("analytic_tflops", "decode_gb_streamed", "decode_step_mb"):
        assert record["roofline"][key] == ref["record"]["roofline"][key]
    assert record["mfu"] is None and record["hbm_utilization"] is None


def test_record_keys_are_bench_py_s(case):
    _, ref, record, _ = case
    assert set(record) == set(ref["record"]) - {"vs_baseline"}
    assert set(record["config"]) == (set(ref["record"]["config"]) - {"baseline"}) | {"card"}
    assert record["metric"] == ref["record"]["metric"] and record["unit"] == ref["record"]["unit"]


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_QUANT": "none", "BENCH_KV": "None", "BENCH_AUDIO_CTX": "300", "BENCH_FUSED": "1",
     "BENCH_CTX_BUCKET": "0", "BENCH_AUDIO_SECONDS": "7.5"},
    {"BENCH_MODEL": "tiny", "BENCH_BEAM": "1", "BENCH_AUDIO_CTX": "none", "BENCH_FUSED": "lineage",
     "BENCH_CTX_BUCKET": "64", "BENCH_LANG": "de", "BENCH_REPEATS": "2"},
    {"BENCH_FUSED": "no", "BENCH_CTX_BUCKET": "", "BENCH_AUDIO_CTX": ""},
])
def test_knobs_parse_as_bench_py(env):
    names = {"model": "MODEL", "batch": "BATCH", "max_new": "MAX_NEW", "repeats": "REPEATS",
             "beam": "BEAM", "dtype": "DTYPE", "lang": "LANG", "quant": "QUANT", "kv_dtype": "KV_DTYPE",
             "audio_ctx": "AUDIO_CTX", "audio_seconds": "AUDIO_SECONDS", "fused": "FUSED",
             "ctx_bucket": "CTX_BUCKET"}
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        g = runpy.run_path(BENCH_PY, run_name="bench_under_test")
        got = bench.knobs()
    assert got == {key: g[name] for key, name in names.items()}
    assert bench.knobs({**env}) == got


def test_refuses_without_a_card_and_a_foreign_engine():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench.run(model="dev", batch=1, max_new=1, repeats=1, beam=1)
    engine = create_engine(EngineType.MONOLITH, bench.bench_config("dev", 1, 4, "float32", "en", None, None,
                                                                   "auto", "auto", "auto"), device="cpu")
    with pytest.raises(ValueError, match="config"):
        bench.run(model="dev", batch=1, max_new=8, repeats=1, beam=1, dtype="float32", engine=engine)
