"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level names are compared
whole: ``whisper_tpu_torch`` begins with ``whisper_tpu`` and is allowed."""

import json
import subprocess
import sys

from port_bench import run


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=run.ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper_tpu_torch_x", sys)
    assert "whisper_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "whisper_tpu.config", sys)
    assert run.forbidden_modules()[-1] == "whisper_tpu.config"


def test_reference_imports_nothing_of_the_program():
    tops = _modules_after("import port_bench.reference.judge, port_bench.reference.whisper")
    assert not tops & {"jax", "jaxlib", "flax", "whisper_tpu", "whisper_tpu_torch"}


def test_a_cpu_run_loads_no_jax():
    code = (
        "from port_bench import run as R\n"
        "from port_bench.tests.conftest import TINY\n"
        "r = R.prepare('large-v3-turbo.offline-short', 7, 'cpu', {'config': TINY, 'traffic': "
        "{'rows': 2, 'max_new_tokens': 3, 'pool': 1, 'judge_requests': 1}})\n"
        "res = R.execute(r, 0.5, False)\n"
        "assert res['correct'], res\n"
        "assert not R.forbidden_modules(), R.forbidden_modules()\n"
    )
    tops = _modules_after(code)
    assert "whisper_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "whisper_tpu"}
