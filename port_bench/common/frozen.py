"""Frozen copies of the program's sound measurement pieces.

Each function below is copied from ``whisper_tpu_torch`` at commit
615005eb77ca2a10f5d8d42dcb9e64044e44f265 and rewritten here, so that a
later change to the program cannot move the yardstick:

* :func:`make_batch` from ``whisper_tpu_torch/utils/bench.py`` (its fixed
  seed 1 becomes an argument);
* :func:`utterances` from ``whisper_tpu_torch/utils/bench_serving.py``
  (its fixed seed 0 becomes an argument);
* :func:`encoder_flops`, :func:`cross_kv_flops` and
  :func:`decoder_flops` from ``whisper_tpu_torch/utils/roofline.py``,
  taking the sizes as plain numbers instead of the program's
  ``ModelDims``.

``port_bench/tests/test_bench_frozen.py`` checks each against its source.
"""

from __future__ import annotations

import numpy as np

N_SAMPLES = 480_000
N_FRAMES = 3_000


def make_batch(batch: int, audio_seconds: float, seed: int = 1) -> np.ndarray:
    """[batch, 480000] float32: ``0.1 · standard_normal`` over the first
    ``audio_seconds`` of each row, zeros after it."""
    rng = np.random.default_rng(seed)
    n_content = min(N_SAMPLES, int(audio_seconds * 16_000))
    out = np.zeros((batch, N_SAMPLES), np.float32)
    out[:, :n_content] = (0.1 * rng.standard_normal((batch, n_content))).astype(np.float32)
    return out


def utterances(n: int, seed: int = 0) -> list:
    """``n`` utterances of 1–30 s of ``0.1 · standard_normal``, each length
    drawn by ``integers(16_000, 480_000)``."""
    rng = np.random.default_rng(seed)
    return [
        (0.1 * rng.standard_normal(int(rng.integers(16_000, 480_000)))).astype(np.float32)
        for _ in range(n)
    ]


def encoder_flops(n_mels: int, d: int, layers: int, t: int, batch: int) -> float:
    """Conv stem + ``layers`` transformer blocks over ``t`` audio positions."""
    conv = 2 * N_FRAMES * 3 * n_mels * d + 2 * t * 3 * d * d
    per_layer = 24 * t * d * d + 4 * t * t * d  # qkvo+mlp, scores+av
    return float(batch) * (conv + layers * per_layer)


def cross_kv_flops(d: int, layers: int, tk: int, batch: int) -> float:
    """K/V projections of the encoder output, once per utterance."""
    return float(batch) * layers * 4 * tk * d * d


def decoder_flops(d: int, layers: int, vocab: int, tk: int, rows: int, p_len: int,
                  steps: float) -> float:
    """Prefill (``p_len`` tokens) + ``steps`` single-token decode steps for
    ``rows`` decode rows (batch·beam). Self-attention context averages
    ``p_len + steps/2`` over a full-budget decode."""
    avg_ctx = p_len + steps / 2.0
    per_tok = layers * (28 * d * d + 4 * (avg_ctx + tk) * d) + 2 * d * vocab
    prefill_per_tok = layers * (28 * d * d + 4 * (p_len / 2.0 + tk) * d) + 2 * d * vocab
    return float(rows) * (steps * per_tok + p_len * prefill_per_tok)
