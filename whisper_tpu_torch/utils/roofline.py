"""Analytic roofline model: FLOPs and HBM bytes for a Whisper transcription
run, plus the card's peak specs, so that a benchmark can report MFU and
HBM-bandwidth utilization beside audio-s/s.

Counterpart of ``whisper_tpu/utils/roofline.py``, with every function kept
as it is there: ``encoder_flops``, ``cross_kv_flops``, ``decoder_flops``,
``decoder_weight_bytes``, ``avg_cache_window``, ``decode_step_bytes`` and
``utilization``. Only the table of cards differs: it holds the NVIDIA H100
SXM, keyed on the name ``torch.cuda.get_device_name()`` gives it, and
:func:`chip_spec` returns None for any other device.

The decode loop is bound by memory bandwidth (weights and KV streamed per
token) and the encoder by the tensor cores, so the two utilization numbers
together say where the headroom is. The byte model is JAX's, which charges
each step its whole physical cache window (``avg_cache_window``, with JAX's
segment growth under ``ctx_bucket``); the port preallocates one cache and
reads only the written window, so for the port it is an upper bound on the
self-cache bytes.

Conventions: a matmul of [m,k]@[k,n] counts 2*m*k*n FLOPs; attention
scores+weighted-sum over context c with width d counts 4*c*d per query row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from whisper_tpu_torch.config import N_FRAMES, ModelDims


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float  # dense FLOP/s
    peak_int8_ops: float
    hbm_bw: float  # bytes/s
    hbm_gb: float


# NVIDIA's H100 SXM datasheet (dense, no sparsity), keyed on the lower-cased
# name torch.cuda.get_device_name() reports.
CHIP_SPECS = {
    "nvidia h100 80gb hbm3": ChipSpec("H100 SXM", 989e12, 1979e12, 3.35e12, 80),
}


def chip_spec(device_kind: str) -> Optional[ChipSpec]:
    dk = device_kind.lower()
    for key, spec in CHIP_SPECS.items():
        if key in dk:
            return spec
    return None


# JAX's segment-growth constants (whisper_tpu/decode/greedy.py), which its
# byte model reads.
CTX_BUCKET = 64
AUTO_MIN_SEGMENTS = 3


def resolve_ctx_bucket(ctx_bucket, total_len: int):
    """Map the config value ("auto" | int | None/0) to an int or None."""
    if ctx_bucket == "auto":
        return CTX_BUCKET if total_len >= AUTO_MIN_SEGMENTS * CTX_BUCKET else None
    return ctx_bucket or None


def ctx_bucket_limits(total_len: int, bucket: int) -> list:
    """JAX's KV-cache segment sizes: multiples of ``bucket`` covering
    1..total_len."""
    return [min(total_len, bucket * (i + 1)) for i in range((total_len + bucket - 1) // bucket)]


def _wbytes(quant: Optional[str]) -> float:
    return 1.0 if quant == "int8" else 2.0  # bf16 default


def _kvbytes(kv_dtype: Optional[str]) -> float:
    if kv_dtype and "8" in str(kv_dtype):
        return 1.0
    return 2.0


def encoder_flops(dims: ModelDims, batch: int) -> float:
    """Conv stem + L transformer blocks over T=1500 audio positions."""
    d, L, T = dims.n_audio_state, dims.n_audio_layer, dims.n_audio_ctx
    conv = 2 * N_FRAMES * 3 * dims.n_mels * d + 2 * T * 3 * d * d
    per_layer = 24 * T * d * d + 4 * T * T * d  # qkvo+mlp, scores+av
    return float(batch) * (conv + L * per_layer)


def cross_kv_flops(dims: ModelDims, batch: int) -> float:
    """K/V projections of the encoder output, once per utterance."""
    d, L, T = dims.n_text_state, dims.n_text_layer, dims.n_audio_ctx
    return float(batch) * L * 4 * T * d * d


def decoder_flops(
    dims: ModelDims, rows: int, p_len: int, steps: float
) -> float:
    """Prefill (p_len tokens) + ``steps`` single-token decode steps for
    ``rows`` decode rows (batch*beam). Self-attention context averages
    p_len + steps/2 over a full-budget decode."""
    d, L, V = dims.n_text_state, dims.n_text_layer, dims.n_vocab
    Tk = dims.n_audio_ctx
    avg_ctx = p_len + steps / 2.0
    per_tok = L * (28 * d * d + 4 * (avg_ctx + Tk) * d) + 2 * d * V
    prefill_per_tok = (
        L * (28 * d * d + 4 * (p_len / 2.0 + Tk) * d) + 2 * d * V
    )
    return float(rows) * (steps * per_tok + p_len * prefill_per_tok)


def decoder_weight_bytes(dims: ModelDims, quant: Optional[str]) -> float:
    """Bytes of decoder weights streamed per decode step: qkvo(self) +
    q,o(cross) + mlp per layer, plus the tied logit matrix."""
    d, L, V = dims.n_text_state, dims.n_text_layer, dims.n_vocab
    return (L * 14 * d * d + d * V) * _wbytes(quant)


def avg_cache_window(
    total_len: int, p_len: int, ctx_bucket: Optional[int]
) -> float:
    """Average physical cache-buffer length over the decode steps.

    With JAX's segment-growth decode (:func:`ctx_bucket_limits`) a step at
    position p runs against a buffer of the smallest covering segment; with
    no bucketing every step streams the full ``total_len`` buffer.
    ``ctx_bucket`` accepts the config forms ("auto" | int | None)."""
    ctx_bucket = resolve_ctx_bucket(ctx_bucket, total_len)
    if not ctx_bucket:
        return float(total_len)

    limits = [
        l for l in ctx_bucket_limits(total_len, ctx_bucket) if l > p_len
    ] or [total_len]
    total, steps = 0.0, 0
    prev = p_len
    for end in limits:
        n = max(0, min(end, total_len) - 1 - prev)  # steps in this segment
        total += n * end
        steps += n
        prev = min(end, total_len) - 1
    # crude but exact enough: count the remaining step(s) at the last size
    remaining = (total_len - 1 - p_len) - steps
    if remaining > 0:
        total += remaining * limits[-1]
        steps += remaining
    return total / max(steps, 1)


def decode_step_bytes(
    dims: ModelDims,
    batch: int,
    beam: int,
    total_len: int,
    quant: Optional[str],
    kv_dtype: Optional[str],
    ctx_bucket: Optional[int] = None,
    p_len: int = 4,
) -> float:
    """HBM bytes streamed per decode step: decoder weights + cross-KV (per
    utterance, shared across beams) + the self-cache buffer (read) at its
    average physical window, plus a read+write of the self-cache for the
    beam reorder when beam > 1."""
    d, L, Tk = dims.n_text_state, dims.n_text_layer, dims.n_audio_ctx
    kvb = _kvbytes(kv_dtype)
    rows = batch * beam
    window = avg_cache_window(total_len, p_len, ctx_bucket)
    cross = 2 * L * batch * d * Tk * kvb
    self_cache = 2 * L * rows * d * window * kvb
    reorder = 2 * self_cache if beam > 1 else 0.0
    return decoder_weight_bytes(dims, quant) + cross + self_cache + reorder


def utilization(
    dims: ModelDims,
    batch: int,
    beam: int,
    p_len: int,
    new_tokens: float,
    total_len: int,
    wall_s: float,
    quant: Optional[str],
    kv_dtype: Optional[str],
    device_kind: str,
    ctx_bucket: Optional[int] = None,
    audio_ctx: Optional[int] = None,  # EngineConfig.audio_ctx crop: cross-KV
    # streams (and encoder-output-dependent FLOPs) scale with the cropped
    # width. NOTE: the encoder itself still runs full-width (the crop is
    # post-encoder), so encoder FLOPs are slightly understated under a crop
    # — acceptable: MFU is decode-dominated in every recorded config.
) -> dict:
    """MFU + decode-phase HBM utilization for one timed batch.

    ``new_tokens`` is the average number of generated tokens per row (the
    decode step count). MFU divides total analytic FLOPs by wall time and
    the chip's bf16 peak (int8 weights still compute in bf16 after dequant).
    ``hbm_utilization`` charges the decode phase's streamed bytes against
    the full wall clock, so it is a *lower bound* on the decode phase's
    actual bandwidth draw (the encoder phase shares the denominator)."""
    rows = batch * beam
    # Post-encoder crop: the encoder runs full-width; cross-KV precompute
    # and every decode-phase cross stream scale with the cropped width.
    import dataclasses as _dc

    ddims = dims
    if audio_ctx is not None and audio_ctx < dims.n_audio_ctx:
        ddims = _dc.replace(dims, n_audio_ctx=audio_ctx)
    flops = (
        encoder_flops(dims, batch)
        + cross_kv_flops(ddims, batch)
        + decoder_flops(ddims, rows, p_len, new_tokens)
    )
    step_bytes = decode_step_bytes(
        ddims, batch, beam, total_len, quant, kv_dtype,
        ctx_bucket=ctx_bucket, p_len=p_len,
    )
    decode_bytes = new_tokens * step_bytes
    spec = chip_spec(device_kind)
    out = {
        "analytic_tflops": round(flops / 1e12, 3),
        "decode_gb_streamed": round(decode_bytes / 1e9, 2),
        "decode_step_mb": round(step_bytes / 1e6, 2),
    }
    if spec is not None and wall_s > 0:
        out["chip"] = spec.name
        out["mfu"] = round(flops / wall_s / spec.peak_bf16_flops, 4)
        out["hbm_utilization"] = round(
            decode_bytes / wall_s / spec.hbm_bw, 4
        )
        # Speed-of-light decode time if every step ran at full HBM BW —
        # the bound the decode loop is optimizing toward.
        out["sol_decode_s"] = round(decode_bytes / spec.hbm_bw, 4)
    return out
