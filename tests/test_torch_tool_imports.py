"""The port's measurement entry points import nothing of JAX, Triton or
the JAX package: ``whisper_tpu_torch.utils.bench``, ``.bench_serving`` and
``.ablate_step``, imported in a fresh interpreter, leave ``jax``,
``triton`` and ``whisper_tpu`` out of ``sys.modules``; and each run as a
module without a card exits non-zero and prints nothing on stdout."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("bench", "bench_serving", "ablate_step")


def test_imports_leave_jax_triton_and_the_reference_out():
    code = (
        "import sys\n"
        "import whisper_tpu_torch.utils.bench, whisper_tpu_torch.utils.bench_serving\n"
        "import whisper_tpu_torch.utils.ablate_step\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or m == 'whisper_tpu'"
        " or m.startswith(('jax.', 'triton.', 'whisper_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("name", MODULES)
def test_entry_point_without_a_card_fails_and_prints_no_result(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run")
    env = dict(os.environ, BENCH_MODEL="dev")
    out = subprocess.run([sys.executable, "-m", f"whisper_tpu_torch.utils.{name}"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA card" in out.stderr and not out.stdout
