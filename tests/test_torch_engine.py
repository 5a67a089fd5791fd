"""whisper_tpu_torch.engine against whisper_tpu.engine, end to end.

The JAX engine's parameters are handed to the port; both transcribe the
same audio with the default EngineConfig at float32, ``dev`` dims, and a
small token budget. Tokens, text and the detected language must be EQUAL,
for MONOLITH and ENCDEC, for short audio (the ``audio_ctx="auto"`` crop) and
for full-window audio.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, Monolith, create_engine
from whisper_tpu_torch.engine.engine import batch_bucket, last_content_index, snap_audio_ctx
from whisper_tpu_torch.models.params import params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(model="dev", dtype="float32", max_new_tokens=12)


@pytest.fixture(scope="module")
def jax_params():
    dims = JaxConfig(**CFG).dims()
    return jax.tree.map(np.asarray, jax_init_params(dims, jax.random.PRNGKey(3)))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


BATCHES = {
    "short": lambda: np.stack([_audio(3.0, 1), _audio(3.0, 2)]),  # crops to 256
    "full": lambda: np.stack([_audio(30.0, 3), _audio(30.0, 4), _audio(30.0, 5)]),
}


@pytest.mark.parametrize("kind", ["MONOLITH", "ENCDEC"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_engine_equal_to_jax(jax_params, kind, batch):
    x = BATCHES[batch]()
    ref = jax_create_engine(JaxType[kind], JaxConfig(**CFG), params=jax_params)
    ours = create_engine(
        EngineType[kind], EngineConfig(**CFG), params=params_from_jax(jax_params), device="cpu"
    )
    a, b = ref.transcribe_batch(x), ours.transcribe_batch(x)
    assert len(a) == len(b) == x.shape[0]
    for r, o in zip(a, b):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.length == r.length
        assert o.text == r.text
        assert o.language == r.language and o.language != ""


def test_timestamps_equal_to_jax(jax_params):
    cfg = dict(CFG, timestamps=True, max_new_tokens=16)
    x = np.zeros((2, 16_000 * 9), np.float32)
    x[0, : 16_000 * 6] = _audio(6.0, 8)
    x[1] = _audio(9.0, 9)
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax_params)
    ours = create_engine(
        EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(jax_params), device="cpu"
    )
    for r, o in zip(ref.transcribe_batch(x), ours.transcribe_batch(x)):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.text == r.text and o.segments is not None
        assert [(s.start, s.end, s.text, s.tokens) for s in o.segments] == [
            (s.start, s.end, s.text, s.tokens) for s in r.segments
        ]


def test_wav_file_and_forced_language(jax_params, tmp_path):
    path = str(tmp_path / "clip.wav")
    write_wav(path, _audio(5.0, 6))
    cfg = dict(CFG, language="de", audio_transfer_dtype="float32", no_speech_threshold=0.6)
    ref = jax_create_engine(JaxType.MONOLITH, JaxConfig(**cfg), params=jax_params)
    ours = create_engine(
        EngineType.MONOLITH, EngineConfig(**cfg), params=params_from_jax(jax_params), device="cpu"
    )
    a, b = ref.transcribe(path), ours.transcribe(path)
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert b.text == a.text and b.language == a.language == "de"
    assert b.is_silent == a.is_silent
    np.testing.assert_allclose(b.no_speech_prob, a.no_speech_prob, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "override",
    [
        dict(beam_size=5, mesh_shape=(1, 2)),
        dict(beam_size=5, mesh_shape=(2, 2)),
        dict(draft_model="tiny", temperature=0.4),  # sampling is ported, the draft is not
        dict(initial_prompt="hello", fallback_temperatures=(0.2, 0.4)),
        dict(mesh_shape=(1, 4), word_timestamps=True),
        dict(draft_model="tiny"),
        dict(mesh_shape=(1, 2)),
        dict(mesh_shape=(2, 2)),
        dict(initial_prompt="hello"),
    ],
)
def test_out_of_slice_configs_raise(override):
    with pytest.raises(NotImplementedError):
        create_engine(EngineType.MONOLITH, EngineConfig(model="dev", **override), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        create_engine(EngineType.MONOLITH, EngineConfig(model="dev"))
    with pytest.raises(RuntimeError, match="cuda"):
        Monolith.from_random(EngineConfig(model="dev"))


def test_random_engine_runs_on_cpu():
    eng = create_engine(EngineType.ENCDEC, EngineConfig(model="dev", max_new_tokens=4), device="cpu")
    (r,) = eng.transcribe_batch(_audio(2.0, 7)[None])
    assert r.length <= 4 + 4 and r.mel_ms is not None and r.model_ms > 0
    assert str(eng.assets.params["decoder"]["tok_emb"].device) == "cpu"


def test_host_helpers():
    assert [batch_bucket(b) for b in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    batch = np.zeros((2, 480_000), np.int16)
    assert last_content_index(batch) == -1
    batch[1, 48_000] = 3
    assert last_content_index(batch) == 48_000
    assert snap_audio_ctx(48_000, 1500) == 256
    assert snap_audio_ctx(479_999, 1500) is None


def test_import_leaves_jax_triton_and_reference_out():
    code = (
        "import sys, whisper_tpu_torch\n"
        "import whisper_tpu_torch.engine, whisper_tpu_torch.ops.attention\n"
        "import whisper_tpu_torch.ops.build, whisper_tpu_torch.models.params\n"
        "import whisper_tpu_torch.decode.beam, whisper_tpu_torch.ops.fused_step\n"
        "import whisper_tpu_torch.ops.gather, whisper_tpu_torch.models.quantize\n"
        "import whisper_tpu_torch.ops.gather_attend, whisper_tpu_torch.frontend.mel_fused\n"
        "import whisper_tpu_torch.utils.probe_fused\n"
        "import whisper_tpu_torch.parallel, whisper_tpu_torch.parallel.mesh\n"
        "import whisper_tpu_torch.parallel.multihost, whisper_tpu_torch.parallel._dist_worker\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or m == 'whisper_tpu'"
        " or m.startswith(('jax.', 'triton.', 'whisper_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
