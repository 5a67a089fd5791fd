"""The run's own look for a card: without one it refuses and prints no
result; with one (marked ``cuda``, skipped here) a short run of a cell is
correct and prints the contract's line last."""

import json
import os

import pytest
import torch

from port_bench import run


@pytest.fixture
def process_settings(monkeypatch):
    """``main`` sets the process's thread count and environment: restore them."""
    threads = torch.get_num_threads()
    for name in ("OMP_NUM_THREADS", "USE_FLAX"):
        monkeypatch.setenv(name, os.environ.get(name, ""))
    yield
    torch.set_num_threads(threads)


def test_refuses_without_a_card(capsys, process_settings):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--workload", "large-v3-turbo.offline-30s", "--seed", "1", "--seconds", "1"]
    assert run.main(argv) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(capsys, process_settings):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    argv = ["--workload", "large-v3-turbo.offline-short", "--seed", "2147483999", "--seconds", "3"]
    assert run.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
