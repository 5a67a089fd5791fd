"""Plain Whisper in float32 PyTorch and NumPy: the reference the served
tokens are judged against.

It imports nothing of ``whisper_tpu``, ``whisper_tpu_torch`` or JAX and
takes nothing the program made: it reads the weights the harness drew
(``common/weights.py``) and the audio the harness made, and works out
again everything the program derives from them, in its own words:

* the samples as the offline engine ships them (:func:`int16_grid`; the
  harness's audio already lies on that grid, so this is the identity);
* whisper.cpp's log-mel (no centre padding, a periodic Hann window, the
  mirrored bins folded in, a Slaney filterbank built here, the floor at
  max − 8, ``(x + 4) / 4``), in float64;
* the encoder and the decoder with a teacher-forced full-sequence pass;
* int8 weights (symmetric absmax per output channel, per row for the
  token table, as ``quantization="int8"`` states) and the e4m3 storage of
  the cross and self K/V (``kv_cache_dtype="float8_e4m3fn"``), by
  :func:`quantize` and :func:`round_e4m3`;
* the crop of ``audio_ctx="auto"`` (:func:`auto_audio_ctx`).

Matrix products run in float32 with TF32 off (:func:`strict_f32`), and
weights are widened to float32 layer by layer as they are used, so that
the reference fits beside the program's weights.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.common.precision import strict_f32  # noqa: F401  (the reference's setting)

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 480_000
N_FRAMES = 3_000
E4M3_MAX = 448.0


def int16_grid(x: np.ndarray) -> np.ndarray:
    """Samples at the 16-bit width the offline engine ships: the nearest
    step of 1/32768, clipped."""
    return (np.clip(np.rint(x.astype(np.float32) * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


# --- audio_ctx="auto": the encoder positions the decode attends to -----------
CTX_BUCKETS = (256, 512, 1024)
CTX_MARGIN = 32  # positions of trailing silence kept


def auto_audio_ctx(batch: np.ndarray, full: int = 1500) -> Optional[int]:
    """The crop for a zero-padded host batch: the last non-zero sample of
    any row, in encoder positions (320 samples each), plus the margin,
    snapped up to the first bucket that holds it; None for the full
    window."""
    cols = np.flatnonzero(np.any(batch != 0, axis=0))
    last = int(cols[-1]) if cols.size else -1
    need = (last // 320 + 1 if last >= 0 else 1) + CTX_MARGIN
    for b in CTX_BUCKETS:
        if need <= b < full:
            return b
    return None


# --- frontend -------------------------------------------------------------
def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / logstep, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale triangles with Slaney area normalisation over the
    201 bins of a 400-point DFT at 16 kHz: [n_mels, 201] float64."""
    bins = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    out = np.zeros((n_mels, bins.size))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        out[m] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return out


def log_mel(samples: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, N] samples (padded or cut to 30 s here) → [B, n_mels, 3000]
    float32 log-mel, computed in float64."""
    x = samples.to(torch.float64)
    if x.shape[1] < N_SAMPLES:
        x = F.pad(x, (0, N_SAMPLES - x.shape[1]))
    x = x[:, :N_SAMPLES]
    x = F.pad(x, (0, (N_FRAMES - 1) * HOP + N_FFT - N_SAMPLES))  # zeros past the end only
    frames = x.unfold(1, N_FFT, HOP)  # [B, 3000, 400]
    i = torch.arange(N_FFT, dtype=torch.float64, device=x.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / N_FFT))
    spec = torch.fft.fft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2  # [B, 3000, 400]
    half = power[..., : N_FFT // 2 + 1].clone()
    half[..., 1 : N_FFT // 2] += power[..., N_FFT // 2 + 1 :].flip(-1)  # mirrored bins folded in
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = half @ fb.t()  # [B, 3000, n_mels]
    logm = torch.log10(torch.clamp(mel, min=1e-10))
    floor = logm.amax(dim=(1, 2), keepdim=True) - 8.0
    logm = (torch.maximum(logm, floor) + 4.0) / 4.0
    return logm.transpose(1, 2).to(torch.float32)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder position table [length, channels]: sines then
    cosines over log-spaced timescales up to 10000."""
    inc = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).to(torch.float32)


# --- storage precisions ---------------------------------------------------
def scaled_e4m3(x: torch.Tensor, reduce_dims) -> torch.Tensor:
    """``x`` stored as float8 e4m3 with an absmax scale over
    ``reduce_dims`` (its largest magnitude maps to 448), returned
    dequantised in float32."""
    xf = x.float()
    amax = xf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax / E4M3_MAX, min=1e-30)
    return round_e4m3(xf / scale) * scale


def quantize(w: torch.Tensor, reduce_dims, bits: int) -> torch.Tensor:
    """Symmetric absmax quantisation to ``bits`` (8: ±127, 4: ±7) over
    ``reduce_dims`` (the scale is per output channel), returned dequantised
    in float32: round half to even of ``w / scale``."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, qmax), min=1e-12)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest float8 e4m3 value (3 mantissa bits,
    exponent bias 7, subnormals in steps of 2^-9, ties to even),
    saturated at ±448, returned in float32."""
    xf = x.float()
    mag = xf.abs()
    _, e = torch.frexp(mag)  # mag = m · 2^e, m in [0.5, 1)
    step = torch.exp2((torch.clamp(e - 1, min=-6) - 3).float())
    q = torch.round(mag / step) * step
    return torch.copysign(torch.clamp(q, max=E4M3_MAX), xf)


# --- the model ------------------------------------------------------------
def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _layer_norm(p, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["g"].float() + p["b"].float()


def _attend(q, k, v, n_head, causal=False):
    """[B, Tq, d] × [B, Tk, d] → [B, Tq, d], float32 softmax attention."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // n_head
    q = q.view(b, tq, n_head, dh).transpose(1, 2)
    k = k.view(b, tk, n_head, dh).transpose(1, 2)
    v = v.view(b, tk, n_head, dh).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(tk - tq + 1)
        s = s.masked_fill(mask, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, tq, d)


class Whisper:
    """The reference over the harness's weight tree ``params``.

    ``weights``: None (as drawn), ``"int8"`` or ``"int4"`` (absmax per
    output channel; the token table per row). ``kv``: None or ``"e4m3"``
    (every cross and self K and V rounded to e4m3 before use).
    ``operands``: None, or ``"e4m3"`` for a computation a precision below
    bfloat16 (the controls): both operands of every weight product in
    e4m3, the weight scaled per output channel, the activation per
    tensor."""

    def __init__(self, params: dict, sizes: dict, weights: Optional[str] = None,
                 kv: Optional[str] = None, operands: Optional[str] = None):
        self.p = params
        self.n_head = sizes["encoder_attention_heads"]
        self.n_text_head = sizes["decoder_attention_heads"]
        self.n_mels = sizes["num_mel_bins"]
        self.bits = {None: None, "int8": 8, "int4": 4}[weights]
        self.kv = kv
        self.fp8 = operands == "e4m3"

    def _w(self, w: torch.Tensor, reduce_dims) -> torch.Tensor:
        w = w.float() if self.bits is None else quantize(w, reduce_dims, self.bits)
        return scaled_e4m3(w, reduce_dims) if self.fp8 else w

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return scaled_e4m3(x, tuple(range(x.dim()))) if self.fp8 else x

    def _linear(self, p, x):
        y = self._x(x) @ self._w(p["w"], (0,))
        return y + p["b"].float() if "b" in p else y

    def _conv(self, p, x, stride):
        y = F.conv1d(self._x(x), self._w(p["w"], (1, 2)), stride=stride, padding=1)
        return y + p["b"].float()[None, :, None]

    def _store(self, x):
        return round_e4m3(x) if self.kv == "e4m3" else x

    def _table(self) -> torch.Tensor:
        return self._w(self.p["decoder"]["tok_emb"], (1,))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, 3000] → [B, 1500, d]."""
        e = self.p["encoder"]
        x = _gelu(self._conv(e["conv1"], mel, 1))
        x = _gelu(self._conv(e["conv2"], x, 2)).transpose(1, 2)
        x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
        for bp in e["blocks"]:
            h = _layer_norm(bp["ln1"], x)
            a = bp["attn"]
            x = x + self._linear(a["o"], _attend(self._linear(a["q"], h), self._linear(a["k"], h),
                                                 self._linear(a["v"], h), self.n_head))
            h = _layer_norm(bp["ln2"], x)
            x = x + self._linear(bp["mlp"]["fc2"], _gelu(self._linear(bp["mlp"]["fc1"], h)))
        return _layer_norm(e["ln_post"], x)

    def logits(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: tokens [B, T] (prompt and served tokens)
        over the encoder states ``enc`` [B, Tk, d] (already cropped) →
        logits [B, T, V] float32, row t predicting token t + 1."""
        dec = self.p["decoder"]
        table = self._table()
        t = tokens.shape[1]
        x = table[tokens] + dec["pos_emb"][:t].float()
        for bp in dec["blocks"]:
            h = _layer_norm(bp["ln1"], x)
            a = bp["attn"]
            k = self._store(self._linear(a["k"], h))
            v = self._store(self._linear(a["v"], h))
            x = x + self._linear(a["o"], _attend(self._linear(a["q"], h), k, v, self.n_text_head,
                                                 causal=True))
            h = _layer_norm(bp["ln2"], x)
            c = bp["cross"]
            k = self._store(self._linear(c["k"], enc))
            v = self._store(self._linear(c["v"], enc))
            x = x + self._linear(c["o"], _attend(self._linear(c["q"], h), k, v, self.n_text_head))
            h = _layer_norm(bp["ln3"], x)
            x = x + self._linear(bp["mlp"]["fc2"], _gelu(self._linear(bp["mlp"]["fc1"], h)))
        return self._x(_layer_norm(dec["ln"], x)) @ table.t()
