"""Which EngineConfig options the port takes, and the HTTP server's report
of the fallback ladder.

* a model axis > 1 (tensor parallelism) is ported, also beside
  ``draft_model`` or ``initial_prompt`` text: one process is refused only
  for the size of its world (such a mesh needs d · m); ``temperature``,
  ``fallback_temperatures`` and ``word_timestamps`` are ported and
  construct.
* A POST to a ``TranscribeServer`` ("sync" and "async") over an engine with
  a ladder returns ``temperature`` and ``compression_ratio`` from the
  result: with the gates off, JSON equal to whisper_tpu's server
  (``avg_logprob`` within 1e-4, f32 sums in another order); with a
  gate no decode clears, the last temperature.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.engine.http_server import TranscribeServer as JaxServer
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.engine.http_server import TranscribeServer
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "override",
    [
        dict(draft_model="tiny", mesh_shape=(1, 2)),
        dict(draft_model="tiny", temperature=0.0, fallback_temperatures=(0.5,), mesh_shape=(1, 2)),
        dict(mesh_shape=(1, 2)),
        dict(mesh_shape=(1, 4), word_timestamps=True),
        dict(initial_prompt="hello", mesh_shape=(2, 2)),
        dict(initial_prompt="hello", temperature=0.3, mesh_shape=(1, 2)),
    ],
)
def test_options_outside_the_port_still_raise(override):
    with pytest.raises(ValueError, match=r"needs \d+ processes, have 1"):
        create_engine(EngineType.MONOLITH, EngineConfig(model="dev", **override), device="cpu")


@pytest.mark.parametrize(
    "override",
    [
        dict(temperature=0.4),
        dict(fallback_temperatures=(0.2, 0.4)),
        dict(temperature=0.2, fallback_temperatures=(0.6, 1.0)),
        dict(word_timestamps=True),
        dict(word_timestamps=True, alignment_heads=((1, 0),)),
        dict(beam_size=2, fallback_temperatures=(0.5,), word_timestamps=True),
    ],
)
def test_ported_options_construct(override):
    eng = create_engine(EngineType.MONOLITH, EngineConfig(model="dev", **override), device="cpu")
    assert eng._schedule[0] == override.get("temperature", 0.0)
    assert (eng._align_mask is not None) == override.get("word_timestamps", False)


CFG = dict(model="dev", language="en", dtype="float32", max_new_tokens=4)
GATES_OFF = dict(fallback_temperatures=(0.5,), logprob_threshold=None, compression_ratio_threshold=None)
ALWAYS = dict(fallback_temperatures=(0.5,), logprob_threshold=1e9, compression_ratio_threshold=None)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jax_init_params(JaxConfig(**CFG).dims(), jax.random.PRNGKey(13)))


def _post(server, body: bytes) -> dict:
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/transcribe", data=body,
        headers={"Content-Type": "application/octet-stream+pcm"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_http_reports_the_ladder(tree, mode):
    body = (0.1 * np.random.default_rng(3).standard_normal(16_000)).astype("<f4").tobytes()
    jax_engine = jax_create_engine(JaxType.MONOLITH, JaxConfig(**CFG, **GATES_OFF), params=tree)
    port = params_from_jax(tree)
    engines = {
        name: create_engine(EngineType.MONOLITH, EngineConfig(**CFG, **extra), params=port, device="cpu")
        for name, extra in (("gates_off", GATES_OFF), ("always", ALWAYS))
    }
    with JaxServer(jax_engine, mode=mode, max_batch=2).start() as j, \
            TranscribeServer(engines["gates_off"], mode=mode, max_batch=2).start() as t:
        ref, ours = _post(j, body), _post(t, body)
    assert ours.pop("avg_logprob") == pytest.approx(ref.pop("avg_logprob"), rel=1e-4, abs=1e-4)
    assert ours == ref
    assert ours["temperature"] == 0.0 and isinstance(ours["compression_ratio"], float)
    with TranscribeServer(engines["always"], mode=mode, max_batch=2).start() as t:
        out = _post(t, body)
    assert out["temperature"] == 0.5 and out["compression_ratio"] > 0.0
