"""The plan of K5's CUDA kernel (whisper_tpu_torch.frontend.mel_fused
``_plan``), checked on the CPU against the dense constants.

The kernel (csrc/log_mel_fused.cu) runs only on the card. What it computes
is fixed by its host tables and its index map, so both are checked here:

* the per-mel bin ranges and weights rebuild ``_basis``'s dense
  fold-prescaled filterbank exactly, which JAX's ``_basis`` equals
  bitwise (tests/test_torch_mel_fused.py);
* the factorised DFT (400 = 20 × 20, the kernel's index map written out
  in numpy below: n = 20·n1 + n2, k = k1 + 20·k2, the Hermitian half of
  stage 1, both folds) on the kernel's float32 tables, evaluated in
  float64, equals the dense windowed basis ``frontend/mel._dft_window_matrices``
  to 1e-6 of the largest |X| (the tables' float32 rounding is the only
  difference);
* the same, evaluated in float32 through the power, the sparse mel
  product, ``log10`` and the epilogue, equals the plain version
  ``log_mel_spectrogram_fused_reference`` to 2e-4 in log-mel units, K5's
  tolerance; and JAX's Pallas kernel (interpret mode) to the same.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.frontend.mel_pallas import log_mel_spectrogram_fused as jax_fused
from whisper_tpu_torch.frontend import mel_fused
from whisper_tpu_torch.frontend.mel import _dft_window_matrices

torch.set_num_threads(2)

N = 480_000
TOL = 2e-4
R = mel_fused.RADIX


def _tables(n_mels, dtype):
    table, ranges, dft20 = mel_fused._plan(n_mels)
    t = table.astype(dtype)
    return (t[:400], t[mel_fused.TW_COS : mel_fused.TW_SIN].reshape(R, R),
            t[mel_fused.TW_SIN : mel_fused.MEL_W].reshape(R, R), dft20[:R].astype(dtype),
            dft20[R:].astype(dtype))


def factorised_dft(frames: np.ndarray, n_mels: int, dtype) -> tuple:
    """The kernel's windowed DFT of ``frames`` [F, 400] in ``dtype``: (re,
    im), each [F, 201], bin by bin as the kernel's threads compute them."""
    window, twc, tws, c, s = _tables(n_mels, dtype)
    x = (frames.astype(dtype) * window).reshape(-1, R, R)  # [F, n1, n2]
    # Stage 1: the Hermitian half (k1 <= 10), input pairs n1, 20 - n1 folded.
    a = {n: x[:, n] + x[:, R - n] for n in range(1, 10)}
    d = {n: x[:, n] - x[:, R - n] for n in range(1, 10)}
    even, odd = x[:, 0] + x[:, 10], x[:, 0] - x[:, 10]
    yr, yi = {}, {0: np.zeros_like(even), 10: np.zeros_like(even)}
    for k1 in range(11):
        re = odd if k1 & 1 else even
        for n in range(1, 10):
            re = re + a[n] * c[n * k1 % R]
        yr[k1] = re
    for k1 in range(1, 10):
        im = d[1] * s[k1 % R]
        for n in range(2, 10):
            im = im + d[n] * s[n * k1 % R]
        yi[k1] = -im
    # Twiddles, then stage 2 over n2 (pairs n2, 20 - n2 folded), only the
    # bins k1 + 20 k2 <= 200; Y[20 - k1] = conj Y[k1].
    re_out = np.zeros((x.shape[0], 201), dtype)
    im_out = np.zeros_like(re_out)
    for k1 in range(R):
        src, conj = (k1, 1) if k1 <= 10 else (R - k1, -1)
        y_r, y_i = yr[src], conj * yi[src]  # [F, n2]
        zr = y_r * twc[k1] + y_i * tws[k1]
        zi = y_i * twc[k1] - y_r * tws[k1]
        for k2 in range((200 - k1) // R + 1):
            sign = -1 if k2 & 1 else 1
            re, im = zr[:, 0] + sign * zr[:, 10], zi[:, 0] + sign * zi[:, 10]
            for n in range(1, 10):
                j = n * k2 % R
                sr, si = zr[:, n] + zr[:, R - n], zi[:, n] + zi[:, R - n]
                dr, di = zr[:, n] - zr[:, R - n], zi[:, n] - zi[:, R - n]
                re = re + sr * c[j] + di * s[j]
                im = im + si * c[j] - dr * s[j]
            re_out[:, k1 + R * k2], im_out[:, k1 + R * k2] = re, im
    return re_out, im_out


def kernel_log_mel(x: np.ndarray, n_mels: int) -> np.ndarray:
    """[480000] → [n_mels, 3000] as the kernel computes it in float32, then
    the epilogue of ``mel_fused``."""
    padded = np.concatenate([x, np.zeros(2999 * 160 + 400 - N, np.float32)])
    frames = np.lib.stride_tricks.sliding_window_view(padded, 400)[::160]  # [3000, 400]
    re, im = factorised_dft(frames, n_mels, np.float32)
    power = re * re + im * im
    table, ranges, _ = mel_fused._plan(n_mels)
    lo, off = ranges[:n_mels], ranges[n_mels:]
    mel = np.stack([power[:, lo[m] : lo[m] + off[m + 1] - off[m]]
                    @ table[mel_fused.MEL_W + off[m] : mel_fused.MEL_W + off[m + 1]]
                    for m in range(n_mels)])  # [n_mels, 3000]
    log_spec = torch.from_numpy(np.log10(np.maximum(mel, 1e-10)))
    return mel_fused._epilogue(log_spec[None], (1,))[0].numpy()


def _signal(seed: int) -> np.ndarray:
    """Speech-like test input: noise, a tone, and silence at the end (quiet
    bins), float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 16_000.0
    x = 0.05 * rng.standard_normal(N) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
    x[400_000:] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_ranges_rebuild_the_dense_filterbank(n_mels):
    table, ranges, _ = mel_fused._plan(n_mels)
    dense = mel_fused._basis(n_mels)[1][:, :n_mels]
    lo, off = ranges[:n_mels], ranges[n_mels:]
    assert off[0] == 0 and off[-1] <= mel_fused.MAX_NNZ and (np.diff(off) > 0).all()
    rebuilt = np.zeros_like(dense)
    for m in range(n_mels):
        rebuilt[lo[m] : lo[m] + off[m + 1] - off[m], m] = table[mel_fused.MEL_W + off[m] : mel_fused.MEL_W + off[m + 1]]
    np.testing.assert_array_equal(rebuilt, dense)
    assert not table[mel_fused.MEL_W + off[-1] :].any()
    assert off[-1] == np.count_nonzero(dense)  # each mel's range holds no zero


@pytest.mark.parametrize("seed", [0, 1])
def test_factorised_dft_equals_the_dense_basis_in_float64(seed):
    rng = np.random.default_rng(seed)
    n = np.arange(400)
    frames = np.concatenate([
        rng.standard_normal((48, 400)),
        np.sin(2 * np.pi * np.outer(rng.uniform(0, 200, 16), n) / 400),  # tones between bins
        np.eye(400)[rng.integers(0, 400, 8)],  # impulses
    ])
    re, im = factorised_dft(frames, 80, np.float64)
    w_cos, w_sin = _dft_window_matrices(400)
    ref_re, ref_im = frames @ w_cos, frames @ w_sin
    scale = np.maximum(np.abs(ref_re), np.abs(ref_im)).max(axis=1, keepdims=True)
    assert (np.abs(re - ref_re) <= 1e-6 * scale).all()
    assert (np.abs(im - ref_im) <= 1e-6 * scale).all()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_float32_plan_equals_plain_version_and_jax(n_mels):
    x = _signal(n_mels)
    ours = kernel_log_mel(x, n_mels)
    plain = mel_fused.log_mel_spectrogram_fused_reference(torch.from_numpy(x), n_mels=n_mels).numpy()
    np.testing.assert_allclose(ours, plain, rtol=0, atol=TOL)
    jax_out = np.asarray(jax_fused(jnp.asarray(x), n_mels=n_mels, interpret=True))
    np.testing.assert_allclose(ours, jax_out, rtol=0, atol=TOL)


def test_all_zero_input_gives_the_floor():
    out = kernel_log_mel(np.zeros(N, np.float32), 80)
    plain = mel_fused.log_mel_spectrogram_fused_reference(torch.zeros(N), n_mels=80).numpy()
    assert (out == out[0, 0]).all() and abs(out[0, 0] + 1.5) < 1e-6  # (log10(1e-10) + 4) / 4
    np.testing.assert_allclose(out, plain, rtol=0, atol=1e-6)


def test_kernel_constants_match_the_plan():
    src = (Path(mel_fused.__file__).parent.parent / "csrc" / "log_mel_fused.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxNnz"] == mel_fused.MAX_NNZ and const["kMelMax"] == mel_fused.MEL_PAD
    assert const["kFft"] == 400 == R * R and const["kHop"] == 160
    table, ranges, dft20 = mel_fused._plan(128)
    assert table.shape == (3 * 400 + mel_fused.MAX_NNZ,) and table.dtype == np.float32
    assert ranges.dtype == np.int32 and dft20.shape == (2 * R,) and dft20.dtype == np.float32
    np.testing.assert_array_equal(table[:400], np.float32(0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))))
    # The count the note of the source states, per frame at 128 mels.
    assert mel_fused.kernel_flops(128) == 400 + 7_420 + 18_597 + 2 * 394 + 128
