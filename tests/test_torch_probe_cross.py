"""whisper_tpu_torch.utils.probe_cross, K6's path, on the CPU at dev dims
(2 layers, 2 heads of 32) against ``tools/probe_cross.py``.

The tool is loaded once per mode (``runpy`` under its ``PROBE_*``
variables and ``dev 2 2``: batch 2, beam 2, Tk 64, 2 iterations, the tool
untouched) and its jitted ``run`` gives ``q[0, 0, 0, 0]`` after the
iterations; the port's ``run(device="cpu")`` starts from the tool's own
``q0, xk, xv``. ``dmastage`` is held against the tool's ``stage``: the
tool's ``dma_upcast`` does not lower on the CPU, and on the CPU the port's
K6 is its plain version, which must equal ``.to(torch.bfloat16)``. The
port's ``kernel`` mode has no counterpart in the tool: it takes head size
64 only (refused at dev's 32), and on the CPU at ``tiny`` it is the plain
version, bitwise ``prod``.

Tolerance: 4 bf16 ulps at the largest |q| of the port's run. Both sides
round the same ops to bf16 (the upcast, the attention output, ``tanh``),
but XLA and PyTorch sum the f32 products in another order and round
``tanh`` at other places, so the last bits of a bf16 result can differ;
each layer's ``tanh`` is contractive, so the difference does not grow.
"""

import os
import runpy
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu_torch.ops import fp8_upcast
from whisper_tpu_torch.utils import probe_cross

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TK, ITERS = 64, 2


def _tool(mode: str, tk: int = TK) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROBE_X", mode)
        mp.setenv("PROBE_TK", str(tk))
        mp.setenv("PROBE_ITERS", str(ITERS))
        mp.setenv("PROBE_KV", "float8_e4m3fn")
        mp.setattr(sys, "argv", ["probe_cross.py", "dev", "2", "2"])
        return runpy.run_path(os.path.join(REPO, "tools", "probe_cross.py"))


@pytest.fixture(scope="module")
def tools():
    return {mode: _tool(mode) for mode in ("prod", "bf16", "stage", "chunk")}


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port(g: dict, mode: str, **kw) -> torch.Tensor:
    inputs = tuple(_f32(g[name]) for name in ("q0", "xk", "xv"))
    res = probe_cross.run("dev", iters=ITERS, warmup=0, mode=mode, device="cpu", inputs=inputs, **kw)
    assert res["steps"] == ITERS and res["layers"] == 2 and res["ms_per_iter"] is None
    return res["q"]


def _bf16_tol(q: torch.Tensor) -> float:
    return 4 * 2.0 ** (np.floor(np.log2(q.float().abs().max().item())) - 7)


@pytest.mark.parametrize("mode", [m for m in probe_cross.MODES if m != "kernel"])
def test_mode_matches_the_tool(tools, mode):
    g = tools["stage" if mode == "dmastage" else mode]
    before = fp8_upcast.launches
    q = _port(g, mode)
    assert fp8_upcast.launches == before  # the plain version on the CPU: nothing launched
    assert q.shape == (2, 2, 2, 32) and q.dtype == torch.bfloat16
    want = float(g["run"](g["q0"], g["xk"], g["xv"]))
    assert abs(q.float().ravel()[0].item() - want) <= _bf16_tol(q)


def test_prod_stage_dmastage_are_bitwise_equal(tools):
    g = tools["prod"]
    prod = _port(g, "prod")
    assert torch.equal(prod, _port(g, "stage")) and torch.equal(prod, _port(g, "dmastage"))


@pytest.mark.parametrize("tk", [64, 63])  # an odd Tk: both read Tk // 2 columns per half
def test_cross_chunked_matches_jax_over_the_whole_tensor(tools, tk):
    g = tools["chunk"]
    rng = np.random.default_rng(tk)
    q = jnp.asarray(rng.standard_normal((2, 2, 2, 32)), jnp.bfloat16)
    kT, vT = (jnp.asarray(rng.standard_normal((2, 2, 32, tk)), jnp.bfloat16).astype(jnp.float8_e4m3fn)
              for _ in range(2))
    want = torch.from_numpy(_f32(g["cross_chunked"](q, kT, vT)))
    got = probe_cross.cross_chunked(
        torch.from_numpy(_f32(q)).to(torch.bfloat16),
        *(torch.from_numpy(_f32(x)).to(torch.float8_e4m3fn) for x in (kT, vT)),
    )
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= _bf16_tol(want)


def test_moved_bytes_at_the_probe_defaults():
    """The reckoning of the docstring at large-v3, batch 16, beam 5, Tk 1500:
    18 bytes per K/V element pair for the fp8 formulations that upcast
    (prod, stage, dmastage), 12 on a bf16 store, 26 for chunk, plus the
    score terms (28 and 52 bytes per score)."""
    n, s = 16 * 20 * 64 * 1500, 16 * 20 * 5 * 1500
    want = {"prod": 18 * n + 28 * s, "stage": 18 * n + 28 * s, "dmastage": 18 * n + 28 * s,
            "bf16": 12 * n + 28 * s, "chunk": 26 * n + 52 * s}
    for mode, per_layer in want.items():
        assert probe_cross.moved_bytes(mode, 32, 16, 5, 20, 64, 1500, 1) == 32 * per_layer


def test_kernel_mode_is_prod_on_the_cpu():
    runs = {mode: probe_cross.run("tiny", 2, 3, 40, iters=2, warmup=0, mode=mode, device="cpu")
            for mode in ("prod", "kernel")}
    assert runs["kernel"]["cross_launches"] is None and runs["kernel"]["layers"] == 4
    assert torch.equal(runs["kernel"]["q"], runs["prod"]["q"])
    with pytest.raises(ValueError, match="cross_attend"):  # dev's heads are 32 wide
        probe_cross.run("dev", 1, 1, 16, mode="kernel", device="cpu")


def test_moved_bytes_of_the_kernel():
    """K and V read once in the store's dtype: 2 bytes per fp8 element pair."""
    n = 16 * 20 * 64 * 1500
    assert probe_cross.moved_bytes("kernel", 32, 16, 5, 20, 64, 1500, 1) == 32 * 2 * n
    assert probe_cross.moved_bytes("kernel", 4, 16, 1, 20, 64, 1500, 2) == 4 * 4 * n


def test_refusals():
    with pytest.raises(ValueError, match="mode"):
        probe_cross.run("dev", 1, 1, 16, mode="dma", device="cpu")
    with pytest.raises(ValueError, match="fp8 store"):
        probe_cross.run("dev", 1, 1, 16, kv="bfloat16", mode="dmastage", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            probe_cross.run("dev", 1, 1, 16)


def test_import_of_k6_and_its_path_leaves_jax_triton_and_reference_out():
    code = (
        "import sys\n"
        "import whisper_tpu_torch.ops.fp8_upcast, whisper_tpu_torch.utils.probe_cross\n"
        "import whisper_tpu_torch.ops.cross_attend\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or m == 'whisper_tpu'"
        " or m.startswith(('jax.', 'triton.', 'whisper_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
