"""whisper_tpu_torch.utils.probe_fused, K3's full-width path, on the CPU at
dev dims (2 layers, 2 heads of 32, D 64) with a small context.

Every mode runs two beam steps through the plain versions; after one step
``attend`` (K3) and ``hybrid`` (K2 + ``qkv_attention``) gathered the same
bytes (bitwise) and give ``h`` within 4 bf16 ulps (``compare_runs``; one
fp8 ulp more on fp8 planes at these few heads and positions);
``dma`` passes ``h`` through ``tanh`` once per layer.
"""

import pytest
import torch

from whisper_tpu_torch.ops import fused_step, gather_attend
from whisper_tpu_torch.utils import probe_fused

torch.set_num_threads(2)

DEV = dict(model="dev", batch=2, beam=3, ctx=9, device="cpu")


@pytest.mark.parametrize("mode", probe_fused.MODES)
@pytest.mark.parametrize("kv", ["float8_e4m3fn", "bfloat16"])
def test_modes_run_two_steps(mode, kv):
    before = (gather_attend.launches, fused_step.launches)
    res = probe_fused.run(**DEV, kv=kv, iters=1, warmup=1, mode=mode)
    assert (gather_attend.launches, fused_step.launches) == before  # plain versions on the CPU
    assert res["steps"] == 2 and res["layers"] == 2 and res["ms_per_step"] is None
    h = res["h"]
    assert h.shape == (6, 64) and h.dtype == torch.bfloat16 and torch.isfinite(h.float()).all()
    pk, _ = res["planes"]
    assert pk.shape == (2, 2, 6, 9, 64) and pk.dtype == getattr(torch, kv)
    assert res["gb"] == 2 * 2 * 2 * 6 * 9 * 64 * pk.element_size() / 1e9


@pytest.mark.parametrize("kv", ["float8_e4m3fn", "bfloat16", "float32"])
def test_attend_equals_hybrid_after_one_step(kv):
    attend = probe_fused.run(**DEV, kv=kv, iters=1, warmup=0, mode="attend")
    hybrid = probe_fused.run(**DEV, kv=kv, iters=1, warmup=0, mode="hybrid")
    # At 2 heads of 32 over 8 positions one fp8 new row that rounds the
    # other way moves the next layer's h by up to an fp8 ulp: allow one.
    cmp = probe_fused.compare_runs(attend, hybrid, h_storage_ulps=1 if kv == "float8_e4m3fn" else 0)
    assert cmp["gathered_equal"] and cmp["ok"], cmp


def test_dma_is_tanh_per_layer():
    h0 = probe_fused.run(**DEV, iters=0, warmup=0, mode="dma")["h"]
    h = probe_fused.run(**DEV, iters=1, warmup=0, mode="dma")["h"]
    assert torch.equal(h, torch.tanh(torch.tanh(h0)))  # bf16 after each layer, as the probe


def test_refusals():
    with pytest.raises(ValueError):
        probe_fused.run(**DEV, mode="hybrid2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            probe_fused.run(model="dev", batch=1, beam=1, ctx=4)
