"""whisper_tpu_torch.utils.roofline against whisper_tpu.utils.roofline.

Every function of the analytic model equals JAX's for every entry of
``MODEL_DIMS``: FLOPs, weight bytes, cache windows (with and without JAX's
segment growth) and per-step bytes under int8 weights and an fp8 KV
cache, and ``utilization`` with an ``audio_ctx`` crop. Only the table of
cards differs: the port's holds the H100 SXM alone, keyed on the name
torch reports, and has no TPU entry.
"""

import dataclasses

import pytest

from whisper_tpu.config import MODEL_DIMS as JAX_DIMS
from whisper_tpu.utils import roofline as jax_roofline
from whisper_tpu_torch.config import MODEL_DIMS
from whisper_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("model", sorted(MODEL_DIMS))
def test_every_function_equal_to_jax(model):
    ours, ref = MODEL_DIMS[model], JAX_DIMS[model]
    assert roofline.encoder_flops(ours, 4) == jax_roofline.encoder_flops(ref, 4)
    assert roofline.cross_kv_flops(ours, 4) == jax_roofline.cross_kv_flops(ref, 4)
    assert roofline.decoder_flops(ours, 20, 4, 60.5) == jax_roofline.decoder_flops(ref, 20, 4, 60.5)
    for quant in (None, "int8"):
        assert roofline.decoder_weight_bytes(ours, quant) == jax_roofline.decoder_weight_bytes(ref, quant)
        for kv in (None, "float8_e4m3fn", "bfloat16"):
            for bucket in (None, "auto", 64, 4):
                args = (4, 5, 224, quant, kv)
                assert roofline.decode_step_bytes(ours, *args, ctx_bucket=bucket, p_len=4) == (
                    jax_roofline.decode_step_bytes(ref, *args, ctx_bucket=bucket, p_len=4)
                )
    for crop in (None, 256, 1500):
        kw = dict(batch=4, beam=5, p_len=4, new_tokens=60.0, total_len=224, wall_s=1.25,
                  quant="int8", kv_dtype="float8_e4m3fn", ctx_bucket="auto", audio_ctx=crop)
        a = roofline.utilization(ours, device_kind=H100, **kw)
        b = jax_roofline.utilization(ref, device_kind="TPU v5p", **kw)
        for key in ("analytic_tflops", "decode_gb_streamed", "decode_step_mb"):
            assert a[key] == b[key]
        # The card's numbers: JAX's formulas over the H100's peaks.
        spec = roofline.chip_spec(H100)
        dd = ours if crop is None or crop >= ours.n_audio_ctx else dataclasses.replace(ours, n_audio_ctx=crop)
        flops = (roofline.encoder_flops(ours, 4) + roofline.cross_kv_flops(dd, 4)
                 + roofline.decoder_flops(dd, 20, 4, 60.0))
        step = roofline.decode_step_bytes(dd, 4, 5, 224, "int8", "float8_e4m3fn", ctx_bucket="auto", p_len=4)
        assert a["chip"] == spec.name
        assert a["mfu"] == round(flops / 1.25 / spec.peak_bf16_flops, 4)
        assert a["hbm_utilization"] == round(60.0 * step / 1.25 / spec.hbm_bw, 4)
        assert a["sol_decode_s"] == round(60.0 * step / spec.hbm_bw, 4)


@pytest.mark.parametrize("total_len, p_len, bucket", [(224, 4, "auto"), (448, 7, 64), (100, 4, None), (40, 4, 4)])
def test_cache_window_equal_to_jax(total_len, p_len, bucket):
    assert roofline.avg_cache_window(total_len, p_len, bucket) == jax_roofline.avg_cache_window(
        total_len, p_len, bucket
    )


def test_the_card_table():
    spec = roofline.chip_spec(H100)
    assert (spec.peak_bf16_flops, spec.peak_int8_ops, spec.hbm_bw, spec.hbm_gb) == (989e12, 1979e12, 3.35e12, 80)
    for other in ("TPU v5p", "TPU v5 lite", "v4", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert roofline.chip_spec(other) is None
    out = roofline.utilization(MODEL_DIMS["tiny"], 1, 1, 4, 10, 14, 1.0, None, None, "TPU v5p")
    assert "mfu" not in out and "chip" not in out
