"""The fallback ladder and word timestamps on a data-parallel mesh: two CPU
ranks (``parallel._dist_worker.launch``, gloo), ``mesh_shape=(2, 1)``, at
``dev`` f32.

* ``transcribe_files`` with a gate no decode clears (``--fallback``): the
  multi-process ladder re-runs the failing paths as passes of their own;
  every rank returns the same rows, each at the last temperature with its
  compression ratio set.
* ``transcribe_batch`` of 3 rows (a bucket of 4, 2 per rank) with the same
  ladder: the retry sub-batch is rounded up to whole shares; every rank
  returns the same rows at the last temperature.
* ``transcribe_batch`` with ``--word-timestamps``: each rank aligns its own
  rows and the matrices are gathered; the words equal a single-process
  engine's on the same weights.
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import EngineConfig
from whisper_tpu_torch.engine import Monolith
from whisper_tpu_torch.models.params import init_params
from whisper_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(2)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    params = init_params(EngineConfig(model="dev").dims(), torch.Generator().manual_seed(5))
    path = str(tmp_path_factory.mktemp("weights") / "params.pt")
    torch.save(params, path)
    return params, path


def _run(weights, tmp_path_factory, name, source, *flags):
    d = tmp_path_factory.mktemp(name)
    args = [*source(d), "--params", weights[1], "--model", "dev", "--device", "cpu",
            "--dtype", "float32", "--max-new", "6", "--threads", "1", *flags]
    return launch(2, args, str(d), timeout=120)


def _files(d):
    paths = []
    for i, s in enumerate((3.0, 1.5, 2.5)):
        paths.append(str(d / f"u{i}.wav"))
        write_wav(paths[-1], _audio(s, i + 1))
    return ["--paths", ",".join(paths)]


def _batch():
    x = np.zeros((3, 16_000 * 3), np.float32)
    for i, s in enumerate((3.0, 2.0, 2.5)):
        a = _audio(s, i + 4)
        x[i, : len(a)] = a
    return x


def _npy(d):
    np.save(d / "batch.npy", _batch())
    return ["--npy", str(d / "batch.npy")]


@pytest.mark.parametrize("source", ["files", "batch"])
def test_ladder_on_two_ranks(weights, tmp_path_factory, source):
    reports = _run(weights, tmp_path_factory, f"ladder_{source}",
                   _files if source == "files" else _npy, "--fallback")
    rows = [r["runs"]["auto"]["results"] for r in reports]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    for row in rows[0]:
        assert row["temperature"] == 0.5
        assert isinstance(row["compression_ratio"], float) and row["compression_ratio"] > 0
        assert row["avg_logprob"] is not None and row["words"] is None


def test_words_on_two_ranks_equal_single_process(weights, tmp_path_factory):
    reports = _run(weights, tmp_path_factory, "words", _npy, "--word-timestamps")
    rows = [r["runs"]["auto"]["results"] for r in reports]
    assert rows[0] == rows[1]
    cfg = EngineConfig(model="dev", dtype="float32", max_new_tokens=6, word_timestamps=True)
    single = Monolith.from_assets(weights[0], cfg, device="cpu").transcribe_batch(_batch())
    for got, want in zip(rows[0], single):
        assert got["tokens"] == want.tokens[: want.length].tolist()
        assert got["words"] == [[w.word, w.start, w.end] for w in want.words]
        assert got["temperature"] is None
