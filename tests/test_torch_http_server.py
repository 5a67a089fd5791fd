"""The port's TranscribeServer against whisper_tpu's, in each mode.

Both servers run over engines with the same weights (``params_from_jax``)
at ``dev`` dims, float32, a 4-token budget, on ``127.0.0.1:0``. The same
WAV body and the same raw-PCM body must give EQUAL JSON on both, and the
servers' own ``transcribe`` equal tokens. A bad body is a 400 and counts
as an error, an unknown route a 404, and ``/metrics`` counts requests.
"""

import io
import json
import struct
import urllib.error
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
from whisper_tpu_torch.audio.wav import read_wav_bytes
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.engine.http_server import TranscribeServer
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

CFG = dict(model="dev", language="en", dtype="float32", max_new_tokens=4)
MODES = ["sync", "async", "continuous"]
# Small pools: one slot bucket and one flush shape keep JAX's warm-up short.
SIZES = dict(n_slots=2, max_batch=2)


def _wav_bytes(samples: np.ndarray, sample_rate: int = 16_000) -> bytes:
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    out = io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 36 + len(data)))
    out.write(b"WAVE")
    out.write(b"fmt ")
    out.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
    out.write(b"data")
    out.write(struct.pack("<I", len(data)))
    out.write(data)
    return out.getvalue()


@pytest.fixture(scope="module")
def engines():
    dims = JaxConfig(**CFG).dims()
    tree = jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(13)))
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**CFG), params=tree)
    ours = create_engine(EngineType.MONOLITH, EngineConfig(**CFG), params=params_from_jax(tree), device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(3)
    return (0.1 * rng.standard_normal(16_000)).astype(np.float32)


@pytest.fixture(scope="module", params=MODES)
def servers(request, engines):
    """JAX's server and the port's, in one mode, started."""
    j = JaxServer(engines[0], mode=request.param, **SIZES).start()
    t = TranscribeServer(engines[1], mode=request.param, **SIZES).start()
    yield request.param, j, t
    j.close()
    t.close()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(url, body, ctype="audio/wav"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _server_transcribe(server, samples):
    """The server's own transcribe, its future read with a timeout (the
    sync mode is a direct engine call)."""
    if server._transcriber is None:
        return server.transcribe(samples)
    return server._transcriber.submit(samples).result(timeout=120)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("body", ["wav", "pcm"])
def test_json_equal_to_jax(servers, audio, body):
    mode, j, t = servers
    data, ctype = (
        (_wav_bytes(audio), "audio/wav") if body == "wav"
        else (audio.astype("<f4").tobytes(), "application/octet-stream+pcm")
    )
    (js, jout), (ts, tout) = (_post(_url(s, "/transcribe"), data, ctype) for s in (j, t))
    assert js == ts == 200
    assert tout == jout
    assert tout["length"] >= 2 and tout["language"] == "en"
    # The same request's tokens through each server's own transcribe.
    samples = read_wav_bytes(data) if body == "wav" else audio
    a, b = _server_transcribe(j, samples), _server_transcribe(t, samples)
    assert b.length == a.length
    np.testing.assert_array_equal(b.tokens[: b.length], a.tokens[: a.length])


def test_healthz_and_metrics(servers, audio):
    mode, j, t = servers
    assert _get(_url(t, "/healthz")) == (200, {"status": "ok", "mode": mode})
    before = _get(_url(t, "/metrics"))[1]
    _post(_url(t, "/transcribe"), _wav_bytes(audio))
    status, m = _get(_url(t, "/metrics"))
    assert status == 200
    assert m["requests"] == before["requests"] + 1 and m["errors"] == before["errors"]
    jm = _get(_url(j, "/metrics"))[1]
    assert set(m) == set(jm)
    assert set(m["throughput"]) == set(jm["throughput"])
    if mode == "continuous":
        assert 0.0 < m["occupancy"] <= 1.0 and m["dispatch_efficiency"] >= m["occupancy"]
    else:  # the engine's transcribe_batch counts what it transcribed
        assert m["throughput"]["utterances"] >= 1 and m["throughput"]["audio_seconds_per_s"] > 0


def test_bad_body_is_400_and_isolated(servers, audio):
    _, _, t = servers
    before = _get(_url(t, "/metrics"))[1]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(_url(t, "/transcribe"), b"not a wav at all")
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(_url(t, "/transcribe"), b"")
    assert err.value.code == 400
    m = _get(_url(t, "/metrics"))[1]
    assert m["errors"] == before["errors"] + 1
    # The server goes on serving.
    assert _post(_url(t, "/transcribe"), _wav_bytes(audio))[0] == 200


def test_unknown_route_404(servers):
    _, _, t = servers
    for do in (lambda: _get(_url(t, "/nope")), lambda: _post(_url(t, "/nope"), b"x")):
        with pytest.raises(urllib.error.HTTPError) as err:
            do()
        assert err.value.code == 404


def test_unknown_mode_raises(engines):
    with pytest.raises(ValueError, match="unknown serve mode"):
        TranscribeServer(engines[1], mode="batch")
