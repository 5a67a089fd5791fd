"""whisper_tpu_torch.utils.ablate_step on the CPU at ``dev`` dims against
``tools/ablate_step.py``.

The tool is loaded once (``runpy`` at ``dev 8 3`` under
``ABLATE_KV=float8_e4m3fn``, ``ABLATE_ITERS=1`` and ``ABLATE_QUANT=int8``:
2 decoder layers, 24 rows, so that ``torch._int_mm``'s shape rules fit;
the tool untouched). Its Pallas reorder (``whisper_tpu.ops.gather.
permute_rows``) is wrapped with ``interpret=True`` while it loads, since
the TPU kernel does not lower on the CPU; its fused row already runs in
interpret mode off a TPU. Every row's step then runs once on the tool's
own operands in both packages. Tolerances, set from the dtypes:

* the reorders (``jnp.take`` / ``index_select``, the one-hot bf16
  product, the int8 product on the fp8 bits, the Pallas kernel / K4) and
  the f32 selection rows: bitwise;
* the bf16 attention rows (cross, self, self_T, fused): 4 bf16 ulps at the
  largest |output| (XLA and PyTorch sum the f32 products in another order);
* the bf16 weight rows: 8 bf16 ulps at the largest |output|: the port's
  ``linear`` rounds each product to bf16 before its f32 bias, where JAX
  rounds once after it, over a chain of 8 products per layer.

The fused row's planes are held bitwise against JAX's oracle
``reference_gather_attend`` put into the tool's step (but for the rows
that layers after the first append: each is the previous layer's output,
which the two sides round apart within the attention tolerance): JAX's kernel in
interpret mode returns write planes that differ from that oracle once the
rows span more than one of its 8-row cells (ROADMAP Queue 3), while its
attention output agrees with the port's.
"""

import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops import fused_step as jax_fused
from whisper_tpu.ops import gather as jax_gather
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.ops import gather, gather_attend
from whisper_tpu_torch.utils import ablate_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, BEAM = 8, 3
FP8, BF16 = torch.float8_e4m3fn, torch.bfloat16


@pytest.fixture(scope="module")
def tool():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ABLATE_KV", "float8_e4m3fn")
        mp.setenv("ABLATE_ITERS", "1")
        mp.setenv("ABLATE_QUANT", "int8")
        mp.setattr(sys, "argv", ["ablate_step.py", "dev", str(BATCH), str(BEAM)])
        # Kept while the module's tests run: each call of the tool's step resolves it anew.
        mp.setattr(jax_gather, "permute_rows", functools.partial(jax_gather.permute_rows, interpret=True))
        yield runpy.run_path(os.path.join(REPO, "tools", "ablate_step.py"))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(g, name, dtype) -> torch.Tensor:
    return torch.from_numpy(_f32(g[name]).copy()).to(dtype)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _ulps(got: torch.Tensor, want) -> float:
    """max |got − want| in bf16 ulps at the largest |want|."""
    want = torch.from_numpy(_f32(want).copy())
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    return (got.float() - want).abs().max().item() / ulp


@pytest.fixture(scope="module")
def port_params(tool):
    tree = params_from_jax(jax.tree.map(np.asarray, tool["params"]))
    qtree = params_from_jax(jax.tree.map(np.asarray, tool["qparams"]))
    return tree["decoder"], qtree["decoder"]


def _inputs(g, port_params) -> dict:
    dec, qdec = port_params
    out = {k: _f32(g[k]) for k in ("q0", "xk", "xv", "ck", "cv", "x0", "u0", "lg0", "ckT", "cvT",
                                     "pk", "pv", "fq0")}
    out["params"] = {"blocks": dec["blocks"], "tok_emb": dec["tok_emb"]}
    out["qparams"] = {"blocks": qdec["blocks"]}
    return out


def test_attention_rows_match_the_tool(tool):
    g = tool
    mask = torch.zeros((1, ablate_step.CTX), dtype=BF16)
    got = ablate_step.cross_step(_t(g, "q0", BF16), 0, _t(g, "xk", FP8), _t(g, "xv", FP8))
    assert got.dtype == BF16 and _ulps(got, g["cross_step"](g["q0"], 0, g["xk"], g["xv"])) <= 4
    want = g["self_step"]((g["q0"], g["ck"], g["cv"]), 0)
    got = ablate_step.self_step((_t(g, "q0", BF16), _t(g, "ck", FP8), _t(g, "cv", FP8)), 0, mask)
    assert _ulps(got[0], want[0]) <= 4
    # The first layer's write lands on the tool's operands: its cache bitwise.
    assert np.array_equal(_bytes(got[1][0]), _bytes(want[1][0]))
    want = g["self_T_step"]((g["q0"], g["ckT"], g["cvT"]), 0)
    got = ablate_step.self_T_step((_t(g, "q0", BF16), _t(g, "ckT", FP8), _t(g, "cvT", FP8)), 0,
                                  torch.zeros((1, 1, 1, ablate_step.CTX)))
    assert _ulps(got[0], want[0]) <= 4
    assert np.array_equal(_bytes(got[1][0]), _bytes(want[1][0]))


def test_weight_and_unembed_rows_match_the_tool(tool, port_params):
    g = tool
    dec, qdec = port_params
    x0 = _t(g, "x0", BF16)
    assert _ulps(ablate_step.weights_step(x0, 0, dec["blocks"]), g["weights_step"](g["x0"], 0, g["dec_blocks"])) <= 8
    assert _ulps(ablate_step.weights_step(x0, 0, qdec["blocks"]),
                 g["weights_step"](g["x0"], 0, g["qdec_blocks"])) <= 8
    got = ablate_step.unembed_step(_t(g, "u0", BF16), 0, dec["tok_emb"])
    assert _ulps(got, g["unembed_step"](g["u0"], 0, g["emb"])) <= 4


@pytest.mark.parametrize("port, tool_name, extra", [
    ("argmax_step", "argmax_step", ()),
    ("log_softmax_step", "softmax_step", ()),
    ("topk_wide_step", "topk_step", (BEAM + 1,)),
    ("topk_step", "laxtopk_step", (BEAM + 1,)),
])
def test_selection_rows_are_bitwise_the_tool(tool, port, tool_name, extra):
    got = getattr(ablate_step, port)(_t(tool, "lg0", torch.float32), 0, *extra)
    assert np.array_equal(got.numpy(), _f32(tool[tool_name](tool["lg0"], 0)))


@pytest.mark.parametrize("port, tool_name", [
    ("reorder_index_select", "take_step"),
    ("reorder_onehot", "onehot_step"),
    ("reorder_int8", "onehot_i8_step"),
    ("reorder_k4", "pallas_step"),
])
def test_reorder_rows_are_bitwise_the_tool(tool, port, tool_name):
    g = tool
    rot32 = torch.from_numpy(np.asarray(g["rot"]).copy()).to(torch.int32)
    rot = rot32 if port == "reorder_k4" else rot32.long()
    cache = {"k": _t(g, "ck", FP8), "v": _t(g, "cv", FP8)}
    before = gather.launches
    got = getattr(ablate_step, port)(cache, 0, rot)
    assert gather.launches == before  # the plain version on the CPU
    want = g[tool_name](g["cache0"], 0)
    for name in ("k", "v"):
        assert got[name].dtype == FP8 and np.array_equal(_bytes(got[name]), _bytes(want[name])), name


@pytest.fixture(scope="module")
def fused_oracle(tool):
    """The tool's fused step with JAX's oracle in place of its kernel."""

    def oracle(*args, n_head, interpret=False):
        return jax_fused.reference_gather_attend(*args, n_head=n_head)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fused, "fused_gather_attend", oracle)
        return jax.jit(lambda c, r: tool["fused_step"](c, jnp.int32(0), r))(
            (tool["fq0"], tool["pk"], tool["pv"]), tool["rot"])


def test_fused_row_matches_the_tool(tool, fused_oracle):
    g = tool
    rot32 = torch.from_numpy(np.asarray(g["rot"]).copy()).to(torch.int32)
    before = gather_attend.launches
    h, pk, pv = ablate_step.fused_step((_t(g, "fq0", BF16), _t(g, "pk", FP8), _t(g, "pv", FP8)), 0,
                                       rot32, g["H"])
    assert gather_attend.launches == before
    kernel = jax.jit(lambda c, r: g["fused_step"](c, jnp.int32(0), r))((g["fq0"], g["pk"], g["pv"]), g["rot"])
    assert h.dtype == BF16 and _ulps(h, kernel[0]) <= 4  # JAX's kernel, interpret mode
    assert _ulps(h, fused_oracle[0]) <= 4
    # Bitwise but for the row appended by the layers after the first: it is
    # the previous layer's output, which the two sides round apart (above).
    keep = np.ones(pk.shape, bool)
    keep[:, 1:, :, -1] = False
    for got, want in ((pk, fused_oracle[1]), (pv, fused_oracle[2])):
        assert np.array_equal(_bytes(got)[keep], _bytes(want)[keep])


def test_run_records_every_row_on_the_tool_inputs(tool, port_params):
    g = tool
    records = ablate_step.run("dev", BATCH, BEAM, "float8_e4m3fn", iters=1, quant="int8", repeats=0,
                              device="cpu", inputs=_inputs(g, port_params))
    assert [r["row"] for r in records] == [
        "cross", "self", "weights", "weights_int8", "unembed", "argmax", "log_softmax", "topk_wide",
        "topk", "reorder_index_select", "reorder_onehot", "reorder_int8", "reorder_k4", "self_T", "fused",
    ]
    by = {r["row"]: r for r in records}
    # JAX's byte formulas, per iteration.
    want_gb = {"cross": g["cross_gb"], "self": g["cache_gb"], "weights": g["dec_gb"],
               "weights_int8": g["qdec_gb"], "unembed": g["emb_gb"], "self_T": g["cache_gb"],
               "fused": g["fused_gb"], "argmax": None, "log_softmax": None, "topk_wide": None,
               "topk": None}
    for name in ("reorder_index_select", "reorder_onehot", "reorder_int8", "reorder_k4"):
        want_gb[name] = 2 * g["cache_gb"]
    for name, gb in want_gb.items():
        rec = by[name]
        assert rec["gb"] == pytest.approx(gb, rel=1e-12, abs=0), name
        assert rec["ms_per_iter"] is None and rec["launches_per_iter"] is None and rec["iterations"] == 1
        assert rec["not_run"] is None and np.isfinite(rec["checksum"])
        if gb:
            assert rec["bound_ms"] == pytest.approx(gb * 1e9 / 3.35e12 * 1e3)
    # The bitwise rows' checksum is the tool's scalar of the same iteration.
    for name, tool_name in (("reorder_index_select", "take_step"), ("reorder_onehot", "onehot_step"),
                            ("reorder_int8", "onehot_i8_step"), ("reorder_k4", "pallas_step")):
        want = g[tool_name](g["cache0"], 0)
        assert by[name]["checksum"] == float(sum(_f32(want[n]).ravel()[0] for n in ("k", "v")))
    want = g["argmax_step"](g["lg0"], 0)
    assert by["argmax"]["checksum"] == float(_f32(want).ravel()[0])


def test_rows_not_run_say_why():
    rows = ablate_step.run("dev", 4, 5, "float8_e4m3fn", iters=1, repeats=0, device="cpu")
    by = {r["row"]: r for r in rows}
    assert "m = k = 20" in by["reorder_int8"]["not_run"] and by["reorder_int8"]["checksum"] is None
    assert "not run" in ablate_step.line(by["reorder_int8"])
    rows = ablate_step.run("dev", 8, 3, "bfloat16", iters=1, repeats=0, device="cpu")
    assert "not 1-byte" in {r["row"]: r for r in rows}["reorder_int8"]["not_run"]
    rows = ablate_step.run("dev", 2, 1, "bfloat16", iters=1, repeats=0, device="cpu")
    assert [r["row"] for r in rows] == ["cross", "self", "weights", "unembed", "argmax", "log_softmax",
                                        "self_T"]
    assert ablate_step.int_mm_fits(80, 80, 228 * 1280) and not ablate_step.int_mm_fits(16, 16, 64)


def test_refusals():
    with pytest.raises(ValueError, match="quant"):
        ablate_step.run("dev", 1, 1, iters=1, quant="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ablate_step.run("dev", 1, 1, iters=1)
