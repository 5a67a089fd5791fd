"""Operations and bytes of the ``uni_moe`` family's work, from its
configuration's sizes and the program's routing counts, for the per-layer
metrics ``moe_expert_roofline.lm`` and ``mfu.lm``.

* The routed experts' kernels (``ops/moe_expert`` in the program): each
  expert a call touches has its three matrices read once (3 · d · f
  bfloat16 values); each routed row reads its d inputs (bfloat16) and adds
  d outputs (float32); 6 · d · f FLOPs a routed row. Their bound is the
  larger of the bytes over the card's bandwidth and the FLOPs over its
  bf16 peak, taken for the prefill and for the decode steps apart (the
  one bound by operations, the other by bytes) and added.
* The whole transcription (``lm_flops``): the tower over the
  ``whisper_audio_time`` · 50 positions the model reads (frozen formula),
  the projector over every pooled position, and per LM position the
  attention's projections and scores, the shared experts and the gate; the
  routed rows as counted; the head at each generated position.
"""

from __future__ import annotations

from typing import Dict, Sequence

from port_bench.common import frozen
from port_bench.common.peaks import H100_SXM


def positions(n_samples: int, c: dict) -> int:
    """LM positions of a clip of ``n_samples`` at 16 kHz."""
    q = c["whisper_query_tokens_size"]
    per = 16_000 * c["whisper_audio_time"] // q
    return int(min(max(n_samples // per, 1), q))


def routed_bytes(touched: int, rows: int, c: dict) -> float:
    d, f = c["hidden_size"], c["dynamic_intermediate_size"]
    return float(touched) * 3 * d * f * 2 + float(rows) * d * (2 + 4)


def routed_flops(rows: int, c: dict) -> float:
    return float(rows) * 6 * c["hidden_size"] * c["dynamic_intermediate_size"]


def routed_bound_s(phases: Dict[str, dict], c: dict) -> float:
    """The least time the routed experts' work of ``phases`` ({"prefill":
    counts, "step": counts}, each with ``touched`` and ``rows``) needs."""
    return sum(max(routed_bytes(p["touched"], p["rows"], c) / H100_SXM["hbm_bytes_per_s"],
                   routed_flops(p["rows"], c) / H100_SXM["bf16_flops"])
               for p in phases.values())


def lm_flops(c: dict, prefix: Sequence[int], steps: int, routed_rows: int) -> float:
    """FLOPs of one batch: rows with prefixes of ``prefix`` positions, then
    ``steps`` decode steps of every row, ``routed_rows`` routed rows in all."""
    t = c["tower"]
    rows = len(prefix)
    d, v, layers = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    dh = d // h
    sf = c["mlp_fixed_expert_num"] * c["shared_intermediate_size"]
    n_gate = c["mlp_dynamic_expert_num"] + c["mlp_dynamic_null_expert_num"]
    tower = frozen.encoder_flops(t["num_mel_bins"], t["d_model"], t["encoder_layers"],
                                 c["whisper_audio_time"] * 50, rows)
    proj = rows * c["whisper_query_tokens_size"] * 2.0 * c["whisper_hidden_size"] * d
    dense = layers * (2.0 * d * (h + 2 * kv) * dh + 2.0 * h * dh * d + 6.0 * d * sf
                      + 2.0 * d * n_gate)
    score = layers * 4.0 * h * dh  # per (query, key) pair
    n_pos = sum(prefix) + rows * steps
    pairs = sum(p * (p + 1) / 2.0 + steps * p + steps * (steps + 1) / 2.0 for p in prefix)
    head = rows * (steps + 1) * 2.0 * d * v
    return tower + proj + n_pos * dense + pairs * score + routed_flops(routed_rows, c) + head
