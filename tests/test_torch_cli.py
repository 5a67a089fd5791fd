"""The port's command line (``whisper_tpu_torch.cli.main``) against
whisper_tpu's, in process, with ``--device cpu``:

* ``transcribe`` of WAV files with a ``dev`` npz checkpoint: the printed
  text equal to JAX's CLI on the same file, in greedy, with a draft model,
  with ``--initial-prompt`` text, with the flagship flags (beam, int8, fp8
  KV), and with timestamps and word timestamps and ``--output-format
  all`` (every file written equal to JAX's);
* the usage errors exit 2, as JAX's do; ``--mesh`` with a model axis > 1,
  or a data axis > 1 outside a process group, exit 2 with a message;
* ``vad``, ``silence-removal``, ``wav-to-pcm``, ``pack-assets``,
  ``convert``, ``info`` (checkpoint and vocab .bin), ``eval`` and
  ``eval-corpus``: output and files equal to JAX's; ``serve`` answers a
  request;
* the writers and WER functions against JAX's on the same results.
"""

import dataclasses
import io
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu.config import MODEL_DIMS as J_DIMS
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu.utils import checkpoint as jckpt
from whisper_tpu.utils import wer as jax_wer
from whisper_tpu.utils import writers as jax_writers
from whisper_tpu_torch import cli
from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.models.convert import openai_state_dict
from whisper_tpu_torch.utils import checkpoint
from whisper_tpu_torch.utils import wer, writers

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    tree = jax.tree.map(np.asarray, jax_init_params(J_DIMS["dev"], jax.random.PRNGKey(31)))
    ckpt = str(d / "dev.npz")
    jckpt.save_params(ckpt, tree, J_DIMS["dev"])
    rng = np.random.default_rng(32)
    wavs = []
    for i, secs in enumerate((1.5, 3.0)):
        x = (0.2 * np.sin(np.arange(int(16_000 * secs)) * (0.05 + 0.02 * i))
             + 0.05 * rng.standard_normal(int(16_000 * secs))).astype(np.float32)
        wavs.append(str(d / f"utt{i}.wav"))
        write_wav(wavs[-1], x)
    pcm = str(d / "utt.pcm")  # near-silence, then noise
    np.concatenate([1e-3 * rng.standard_normal(8_000), 0.3 * rng.standard_normal(8_000)]).astype(
        "<f4").tofile(pcm)
    return d, ckpt, wavs, pcm


def _run(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


BASE = ["--checkpoint", None, "--dtype", "float32", "--max-new-tokens", "6"]


@pytest.mark.parametrize(
    "extra",
    [
        ["--language", "en"],
        ["--language", "en", "--draft-model", "dev", "--k-draft", "3"],
        ["--initial-prompt", "hello there, friend"],
        ["--language", "de", "--beam-size", "2", "--quantize", "int8", "--kv-dtype", "float8_e4m3fn"],
        ["--language", "en", "--engine", "encdec", "--clean", "--timestamps"],
    ],
)
def test_transcribe_prints_jax_text(files, capsys, extra):
    d, ckpt, wavs, _ = files
    argv = ["transcribe", *wavs] + [ckpt if a is None else a for a in BASE] + extra
    code, ours, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jcode, ref, _ = _run(jax_cli.main, argv, capsys)
    assert code == jcode == 0
    assert ours == ref
    assert len(ours.splitlines()) >= len(wavs)


def test_output_formats_equal_to_jax(files, capsys):
    d, ckpt, wavs, _ = files
    argv = ["transcribe", wavs[1]] + [ckpt if a is None else a for a in BASE] + [
        "--language", "en", "--timestamps", "--word-timestamps", "--output-format", "all"]
    code, ours, _ = _run(cli.main, argv + ["--device", "cpu", "--output-dir", str(d / "port")], capsys)
    jcode, ref, _ = _run(jax_cli.main, argv + ["--output-dir", str(d / "jax")], capsys)
    assert code == jcode == 0 and ours == ref
    for fmt in ("txt", "srt", "vtt", "tsv", "json"):
        a = (d / "port" / f"utt1.{fmt}").read_text()
        b = (d / "jax" / f"utt1.{fmt}").read_text()
        assert a == b, fmt


@pytest.mark.parametrize(
    "argv, jax_too",
    [
        (["--draft-model", "nope"], True),
        (["--draft-checkpoint", "x.npz"], True),
        (["--model", "tiny"], True),  # a dev checkpoint asked to be tiny
        (["--initial-prompt-tokens", "1,x"], True),
        (["--fallback-temperatures", "0.2,hot"], True),
        (["--mesh", "2"], True),
        (["--mesh", "1,2"], False),  # tensor parallelism: not ported
        (["--mesh", "2,1"], False),  # a data axis outside a process group
    ],
)
def test_usage_errors_exit_2(files, capsys, argv, jax_too):
    d, ckpt, wavs, _ = files
    full = ["transcribe", wavs[0], "--checkpoint", ckpt] + argv
    code, _, err = _run(cli.main, full + ["--device", "cpu"], capsys)
    assert code == 2 and err.startswith("error: "), err
    if jax_too:
        assert _run(jax_cli.main, full, capsys)[0] == 2


def test_audio_tools_equal_to_jax(files, capsys):
    d, _, wavs, pcm = files
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        assert main(["wav-to-pcm", wavs[0], str(d / f"{tag}.pcm")]) == 0
        assert main(["silence-removal", "--input", pcm, "--output", str(d / f"{tag}.kept"),
                     "--threshold-db", "-12"]) == 0
        assert main(["vad", "--input", pcm, "--threshold", "0.09"]) == 0
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and any("Speech" in ln for ln in out) and any("Silence" in ln for ln in out)
    for ext in ("pcm", "kept"):
        assert (d / f"port.{ext}").read_bytes() == (d / f"jax.{ext}").read_bytes()


def test_convert_info_and_pack_assets_equal_to_jax(files, capsys):
    d, ckpt, _, _ = files
    params, dims = checkpoint.load_params(ckpt)
    pt = str(d / "dev.pt")
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": openai_state_dict(params)}, pt)
    outs = {}
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        assert main(["convert", "--checkpoint", pt, "--output", str(d / f"{tag}.npz")]) == 0
        assert main(["pack-assets", "--output", str(d / f"{tag}.bin"), "--multilingual"]) == 0
        capsys.readouterr()
        infos = []
        for art in (str(d / f"{tag}.npz"), str(d / f"{tag}.bin")):
            assert main(["info", art, "--multilingual"]) == 0
            infos.append(json.loads(capsys.readouterr().out))
        outs[tag] = infos
    with np.load(d / "port.npz") as a, np.load(d / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert (d / "port.bin").read_bytes() == (d / "jax.bin").read_bytes()
    for ours, ref in zip(outs["port"], outs["jax"]):
        ours.pop("path"), ref.pop("path")
        assert ours == ref
    assert outs["port"][0]["model"] == "dev" and outs["port"][0]["dtypes"] == ["float32"]


def test_eval_and_eval_corpus_equal_to_jax(files, capsys):
    d, ckpt, wavs, _ = files
    (d / "refs.txt").write_text("the cat sat\nhello, World!\n")
    (d / "hyps.txt").write_text("the cat sat down\nhello world\n")
    args = ["eval", "--refs", str(d / "refs.txt"), "--hyps", str(d / "hyps.txt")]
    assert _run(cli.main, args, capsys)[1] == _run(jax_cli.main, args, capsys)[1]
    (d / "manifest.tsv").write_text(f"# wav\\tref\n{wavs[0]}\tsome words\n{wavs[1]}\tmore words here\n")
    args = ["eval-corpus", "--manifest", str(d / "manifest.tsv"), "--checkpoint", ckpt,
            "--dtype", "float32", "--max-new-tokens", "4", "--language", "en", "--batch-size", "2"]
    ours = json.loads(_run(cli.main, args + ["--device", "cpu"], capsys)[1])
    ref = json.loads(_run(jax_cli.main, args, capsys)[1])
    keys = ("wer", "substitutions", "deletions", "insertions", "hits", "ref_words", "utterances")
    assert {k: ours[k] for k in keys} == {k: ref[k] for k in keys}
    (d / "empty.tsv").write_text("# nothing\n")
    assert cli.main(["eval-corpus", "--manifest", str(d / "empty.tsv"), "--device", "cpu"]) == 2


def test_serve_answers_a_request(files, capsys, monkeypatch):
    from whisper_tpu_torch.engine import http_server

    d, ckpt, wavs, _ = files
    answers = []

    def serve_once(server):
        server.start()
        with open(wavs[0], "rb") as f:
            req = urllib.request.Request(f"http://{server.host}:{server.port}/transcribe",
                                         data=f.read(), headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            answers.append(json.loads(resp.read()))
        server.close()

    monkeypatch.setattr(http_server.TranscribeServer, "serve_forever", serve_once)
    code = cli.main(["serve", "--port", "0", "--mode", "sync", "--checkpoint", ckpt, "--dtype",
                     "float32", "--max-new-tokens", "4", "--language", "en", "--device", "cpu"])
    assert code == 0 and "serving on http://127.0.0.1:" in capsys.readouterr().err
    cfg = EngineConfig(model="dev", dtype="float32", max_new_tokens=4, language="en")
    engine = create_engine(EngineType.MONOLITH, cfg, params=checkpoint.load_params(ckpt)[0], device="cpu")
    assert answers[0]["text"] == engine.transcribe(wavs[0]).text


# --- writers and WER ---------------------------------------------------------


def test_writers_and_wer_equal_to_jax(files, tmp_path):
    """The same decoded results (the port's engine) through both packages'
    writers: every format's text equal; a long-form result too."""
    d, ckpt, wavs, _ = files
    cfg = EngineConfig(model="dev", dtype="float32", max_new_tokens=8, language="en",
                       timestamps=True, word_timestamps=True)
    engine = create_engine(EngineType.MONOLITH, cfg, params=checkpoint.load_params(ckpt)[0], device="cpu")
    results = [engine.transcribe(wavs[1]), engine.transcribe_long(np.zeros(40 * 16_000, np.float32) + 0.01)]
    for r in results:
        for fmt in ("txt", "srt", "vtt", "tsv", "json"):
            a, b = io.StringIO(), io.StringIO()
            writers.WRITERS[fmt](r, a)
            jax_writers.WRITERS[fmt](r, b)
            assert a.getvalue() == b.getvalue(), fmt
    for s in (0.0, 1.2345, 59.9996, 3599.9995, 3723.5, -1.0):
        for kw in ({}, {"always_include_hours": True, "decimal_marker": ","}):
            assert writers.format_timestamp(s, **kw) == jax_writers.format_timestamp(s, **kw)
    written = writers.write_result(results[0], "/x/utt1.wav", "all", str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == [f"utt1.{f}" for f in sorted(writers.WRITERS)]
    with pytest.raises(ValueError):
        writers.write_result(results[0], "/x/a.wav", "doc", str(tmp_path))

    refs = ["the cat sat on the mat", "Hello, world!", "", "don't stop me now"]
    hyps = ["the cat sat on mat", "hello world", "extra", "do not stop me now please"]
    for norm in (True, False):
        assert wer.word_error_rate(refs, hyps, normalize=norm).as_dict() == \
            jax_wer.word_error_rate(refs, hyps, normalize=norm).as_dict()
    assert wer.normalize_text(" It's  A—Test! ") == jax_wer.normalize_text(" It's  A—Test! ")
    with pytest.raises(ValueError):
        wer.word_error_rate(["a"], [])
