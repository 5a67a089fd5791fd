"""The port's copies of the JAX-free modules against the originals: the
tokenizer (vocab layouts, detokenizer, the ``.bin`` asset reader), WAV/PCM
reading, and the engine's ``vocab_bin`` path. Copies must agree exactly.
"""

import numpy as np
import pytest

import whisper_tpu.audio.wav as jwav
import whisper_tpu.tokenizer.binfmt as jbin
import whisper_tpu.tokenizer.detokenize as jdetok
import whisper_tpu.tokenizer.vocab as jvocab
import whisper_tpu_torch.audio.wav as twav
import whisper_tpu_torch.tokenizer.binfmt as tbin
import whisper_tpu_torch.tokenizer.detokenize as tdetok
import whisper_tpu_torch.tokenizer.vocab as tvocab
from whisper_tpu_torch.frontend.filters import mel_filterbank


@pytest.mark.parametrize(
    "multilingual, num_languages", [(False, None), (True, None), (True, 100)]
)
def test_vocab_layouts_equal(multilingual, num_languages):
    ours = tvocab.Vocab.synthetic(multilingual=multilingual, num_languages=num_languages)
    ref = jvocab.Vocab.synthetic(multilingual=multilingual, num_languages=num_languages)
    assert vars(ours.specials) == vars(ref.specials)
    assert ours.id_to_token == ref.id_to_token
    for n_vocab in (51_864, 51_865, 51_866):
        assert tvocab.num_languages_for(n_vocab) == jvocab.num_languages_for(n_vocab)


def test_decode_tokens_equal():
    ours = tvocab.Vocab.synthetic(multilingual=True)
    ref = jvocab.Vocab.synthetic(multilingual=True)
    ids = [50258, 50259, 50359, 50363, 72, 105, 32, 32, 33, 50257, 65]
    for omit in (True, False):
        assert tdetok.decode_tokens(ours, ids, omit) == jdetok.decode_tokens(ref, ids, omit)
    assert tdetok.remove_extra_spaces("a  b   c") == jdetok.remove_extra_spaces("a  b   c")


def _bin_file(tmp_path, size_prefix):
    path = str(tmp_path / f"assets_{size_prefix}.bin")
    table = tvocab.Vocab.synthetic(multilingual=True).id_to_token
    tbin.write_bin(path, mel_filterbank(n_mels=80), table, size_prefix=size_prefix)
    return path


@pytest.mark.parametrize("size_prefix", [True, False])
def test_read_bin_equal(tmp_path, size_prefix):
    path = _bin_file(tmp_path, size_prefix)
    ours, ref = tbin.read_bin(path, True), jbin.read_bin(path, True)
    np.testing.assert_array_equal(ours.mel_filters, ref.mel_filters)
    assert ours.vocab.id_to_token == ref.vocab.id_to_token
    assert (ours.magic, ours.had_size_prefix) == (ref.magic, ref.had_size_prefix)


def _write_raw_wav(path, data: bytes, fmt: int, channels: int, bits: int, rate=16_000):
    import struct

    block = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate, rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize(
    "kind", ["pcm16_mono", "pcm16_stereo", "pcm16_stereo_quirks", "float32_stereo", "pcm32_mono"]
)
def test_read_wav_equal(tmp_path, kind):
    rng = np.random.default_rng(0)
    path = str(tmp_path / f"{kind}.wav")
    channels = 2 if "stereo" in kind else 1
    if kind.startswith("pcm16"):
        data = rng.integers(-32768, 32767, size=800 * channels).astype("<i2").tobytes()
        _write_raw_wav(path, data, 1, channels, 16)
    elif kind.startswith("float32"):
        data = (0.3 * rng.standard_normal(800 * channels)).astype("<f4").tobytes()
        _write_raw_wav(path, data, 3, channels, 32)
    else:
        data = rng.integers(-(2**31), 2**31 - 1, size=800).astype("<i4").tobytes()
        _write_raw_wav(path, data, 1, channels, 32)
    quirks = kind.endswith("quirks")
    ours = twav.read_wav(path, reference_quirks=quirks)
    ref = jwav.read_wav(path, reference_quirks=quirks)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if kind == "pcm16_mono":
        np.testing.assert_array_equal(twav.read_wav_legacy(path), jwav.read_wav_legacy(path))


def test_read_pcm_and_write_wav_equal(tmp_path):
    x = (0.2 * np.random.default_rng(1).standard_normal(1234)).astype(np.float32)
    pcm = str(tmp_path / "x.pcm")
    x.astype("<f4").tofile(pcm)
    np.testing.assert_array_equal(twav.read_pcm_f32(pcm), jwav.read_pcm_f32(pcm))
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    twav.write_wav(a, x)
    jwav.write_wav(b, x)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_engine_vocab_bin_equal_to_jax(tmp_path):
    import jax

    from whisper_tpu.config import EngineConfig as JaxConfig
    from whisper_tpu.engine import EngineType as JaxType
    from whisper_tpu.engine import create_engine as jax_create_engine
    from whisper_tpu.models.params import init_params as jax_init_params
    from whisper_tpu_torch.config import EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine
    from whisper_tpu_torch.models.params import params_from_jax

    path = _bin_file(tmp_path, True)
    cfg = dict(model="dev", dtype="float32", max_new_tokens=6, language="en")
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(**cfg).dims(), jax.random.PRNGKey(5)))
    ref = jax_create_engine(JaxType.ENCDEC, JaxConfig(**cfg), params=tree, vocab_bin=path)
    ours = create_engine(
        EngineType.ENCDEC, EngineConfig(**cfg), params=params_from_jax(tree),
        vocab_bin=path, device="cpu",
    )
    x = (0.1 * np.random.default_rng(2).standard_normal((1, 32_000))).astype(np.float32)
    a, b = ref.transcribe_batch(x)[0], ours.transcribe_batch(x)[0]
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert b.text == a.text
