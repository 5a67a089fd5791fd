"""The Uni-MoE family: an audio language model (a Whisper-large encoder,
pool and linear projector, then a decoder-only mixture-of-experts LM with
shared, routed and null experts), ``whisper_tpu_torch``'s
``AUDIO_LM_DIMS`` models.

* ``check``: the file's sizes (the published config's keys) against the
  table's entry that ``program_model`` names;
* ``make_params``: the weights in the program's layout
  (``whisper_tpu_torch/models/audio_lm.py``), drawn from the seed on the
  device in bfloat16 (the gate in float32), every leaf a view into one
  flat buffer filled by a few large ``randn`` calls and then scaled in
  place: matrices ``fan_in^-0.5``, norm gains ``1 + 0.1·n``, biases
  ``0.02·n``, the token table ``n``;
* ``prompt_ids``: the text ids before and after the audio, drawn from the
  seed (they stand in for the chat template's);
* ``judge``: the float32 reference of ``reference/uni_moe.py``,
  teacher-forced over each judged row's prompt and generated ids with the
  program's routing of those positions (the driver's ``routing`` of each
  item, ``AudioLM.last_routing``), so that a choice rounding decided in
  the program does not move the reference by a whole expert's output:
  ``top1_gap`` and ``malformed`` as the Whisper greedy cells define them
  (no token is suppressed here). The routing is judged apart:
  ``routing_mismatch`` counts the (position, layer) choices where the
  reference's own choice, :data:`ROUTING_MARGIN` or more from another
  choice (its top probability from ``top_p``, or the last taken from the
  first left out), differs from the program's set. The control is the
  same reference with both operands of every weight product in e4m3, run
  with the same routing, so that its ``top1_gap`` reads the precision
  alone; its own gate's choices against the program's, outside the
  reference's margin, are ``control.routing_mismatch``. Printed, not
  compared: ``routing_mismatch.share`` (of all choices),
  ``routing_mismatch.margin`` (the largest margin of a mismatch),
  ``routing_differ.margins`` (the largest margins where the routing
  differed at all), ``routing_boundary_share`` (the reference's choices
  whose top probability lay within 1e-3 of ``top_p``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from port_bench.common import weights
from port_bench.drivers.common import rng
from port_bench.reference import judge as judge_mod
from port_bench.reference.uni_moe import UniMoE

CHUNK = 1 << 27  # elements per randn call
# A routing choice whose probabilities lie this close to another choice may
# go either way between the bf16 program and the float32 reference: at the
# published size the largest margin of such a difference in sound runs
# read 0.038 (22 seeds; PERF.md §4), about twice that is the margin.
ROUTING_MARGIN = 0.08


def check(config: dict) -> None:
    from whisper_tpu_torch.config import AUDIO_LM_DIMS

    d = AUDIO_LM_DIMS[config["program_model"]]
    t = config["tower"]
    assert (d.n_state, d.n_layer, d.n_head, d.n_kv_head, d.n_vocab, d.n_routed, d.n_null,
            d.n_shared, d.routed_width, d.shared_width, d.top_p, d.top_k, d.rope_theta,
            d.norm_eps, d.tower.n_audio_state, d.audio_ctx, d.audio_ctx // d.pool, d.stop) == (
        config["hidden_size"], config["num_hidden_layers"], config["num_attention_heads"],
        config["num_key_value_heads"], config["vocab_size"], config["mlp_dynamic_expert_num"],
        config["mlp_dynamic_null_expert_num"], config["mlp_fixed_expert_num"],
        config["dynamic_intermediate_size"], config["shared_intermediate_size"],
        config["mlp_dynamic_top_p"], config["mlp_dynamic_top_k"], config["rope_theta"],
        config["rms_norm_eps"], config["whisper_hidden_size"], config["whisper_audio_time"] * 50,
        config["whisper_query_tokens_size"], config["stop_token_id"])
    assert (d.tower.n_audio_state, d.tower.n_audio_layer, d.tower.n_audio_head, d.tower.n_mels,
            d.tower.n_audio_ctx) == (t["d_model"], t["encoder_layers"],
                                     t["encoder_attention_heads"], t["num_mel_bins"],
                                     t["max_source_positions"])
    assert d.n_head * d.head_dim == d.n_state and d.tower.n_audio_state == t["d_model"]


def _layout(c: dict) -> List[Tuple[tuple, tuple, str, float]]:
    """[(key path, shape, kind, std)] of every bfloat16 leaf."""
    t = c["tower"]
    tower = weights._layout({
        "d_model": t["d_model"], "encoder_ffn_dim": t["encoder_ffn_dim"],
        "num_mel_bins": t["num_mel_bins"], "encoder_layers": t["encoder_layers"],
        "vocab_size": 1, "max_target_positions": 1, "decoder_layers": 0, "decoder_ffn_dim": 1})
    leaves = [(("tower",) + path, shape, kind, std) for path, shape, kind, std in tower
              if path[0] == "encoder"]
    d, v = c["hidden_size"], c["vocab_size"]
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    dh = d // h
    e, f = c["mlp_dynamic_expert_num"], c["dynamic_intermediate_size"]
    fs = c["shared_intermediate_size"]
    sf = c["mlp_fixed_expert_num"] * fs

    def dense(path, d_in, d_out, bias=True):
        leaves.append((path + ("w",), (d_in, d_out), "w", d_in ** -0.5))
        if bias:
            leaves.append((path + ("b",), (d_out,), "b", 0.02))

    dense(("projector",), c["whisper_hidden_size"], d)
    leaves.append((("embed",), (v, d), "w", 1.0))
    for i in range(c["num_hidden_layers"]):
        b = ("blocks", i)
        leaves.append((b + ("attn_norm",), (d,), "g", 0.1))
        dense(b + ("attn", "q"), d, h * dh)
        dense(b + ("attn", "k"), d, kv * dh)
        dense(b + ("attn", "v"), d, kv * dh)
        dense(b + ("attn", "o"), h * dh, d, bias=False)
        leaves.append((b + ("moe_norm",), (d,), "g", 0.1))
        leaves.append((b + ("shared", "w_gate"), (d, sf), "w", d ** -0.5))
        leaves.append((b + ("shared", "w_up"), (d, sf), "w", d ** -0.5))
        leaves.append((b + ("shared", "w_down"), (sf, d), "w", fs ** -0.5))
        leaves.append((b + ("experts", "w_gate"), (e, d, f), "w", d ** -0.5))
        leaves.append((b + ("experts", "w_up"), (e, d, f), "w", d ** -0.5))
        leaves.append((b + ("experts", "w_down"), (e, f, d), "w", f ** -0.5))
    leaves.append((("norm",), (d,), "g", 0.1))
    leaves.append((("head",), (d, v), "w", d ** -0.5))
    return leaves


def _fill(flat: torch.Tensor, gen: torch.Generator) -> None:
    for start in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - start)
        flat[start:start + n] = torch.randn(n, generator=gen, device=flat.device,
                                            dtype=torch.float32)


def make_params(config: dict, seed: int, device) -> dict:
    """The weight tree for the file's sizes, drawn from ``seed`` on
    ``device``. Stops first where the program has no such model."""
    check(config)
    leaves = _layout(config)
    total = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    _fill(flat, gen)
    tree: dict = {}
    off = 0
    for path, shape, kind, std in leaves:
        n = int(torch.Size(shape).numel())
        leaf = flat[off:off + n].view(shape)
        off += n
        leaf.mul_(std)
        if kind == "g":
            leaf.add_(1.0)
        weights._place(tree, path, leaf)
    d, n_gate = config["hidden_size"], config["mlp_dynamic_expert_num"] + config[
        "mlp_dynamic_null_expert_num"]
    gates = torch.empty(config["num_hidden_layers"] * d * n_gate, dtype=torch.float32,
                        device=device)
    _fill(gates, gen)
    gates = gates.mul_(d ** -0.5).view(config["num_hidden_layers"], d, n_gate)
    for i, block in enumerate(tree["blocks"]):
        block["gate"] = gates[i]
    return tree


def prompt_ids(seed: int, config: dict) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The text ids before and after the audio, drawn from the seed below
    the first special id."""
    pr = config["prompt"]
    ids = rng(seed, 500).integers(0, pr["id_high"], pr["prefix_ids"] + pr["suffix_ids"])
    ids = tuple(int(i) for i in ids)
    return ids[: pr["prefix_ids"]], ids[pr["prefix_ids"]:]


def _well_formed(toks: np.ndarray, length: int, max_new: int, stop: int, vocab: int) -> bool:
    return (len(toks) == max_new and 1 <= length <= max_new
            and bool(((toks >= 0) & (toks < vocab)).all())
            and bool((toks[length:] == stop).all())
            and (length == max_new or toks[length - 1] == stop)
            and stop not in toks[: length - 1].tolist())


def _given(items: list, n_layer: int) -> Optional[list]:
    """The program's routing of each item's judged positions, per layer,
    per row: its prefix's, then the steps that fed its generated ids but
    the last (int8 codes [T, K]); None where an item carries none."""
    if not all(it.get("routing") is not None for it in items):
        return None
    return [[np.concatenate([it["routing"][0][li], it["routing"][1][li, : it["generated"] - 1]])
             for it in items] for li in range(n_layer)]


def _disagree(chosen: list, used: list, margins: list, within: float) -> int:
    """Choices of ``chosen`` whose set differs from ``used``'s where the
    margin of ``used``'s own choice is at least ``within``."""
    n = 0
    for per_c, per_u, per_m in zip(chosen, used, margins):
        for (ci, cp), (ui, up), m in zip(per_c, per_u, per_m):
            a = torch.where(cp, ci, -1).sort(-1).values
            b = torch.where(up, ui, -1).sort(-1).values
            n += int(((a != b).any(-1) & (m >= within)).sum())
    return n


def _largest(margins: List[torch.Tensor], n: int = 8) -> List[float]:
    """The ``n`` largest margins of the choices where the program's routing
    differed from the reference's own (a diagnostic for the margin)."""
    flat = torch.cat([m.flatten().cpu() for m in margins]) if margins else torch.zeros(0)
    return [float(v) for v in flat.sort(descending=True).values[:n]]


def judge(run, items: list, control: bool = False) -> dict:
    c = run.config
    ref = UniMoE(run.params, c)
    ctrl = UniMoE(run.params, c, operands="e4m3") if control else None
    pre, suf = prompt_ids(run.seed, c)
    stop, max_new = c["stop_token_id"], run.traffic["max_new_tokens"]
    good = []
    malformed = 0
    for it in items:
        toks = np.asarray(it["tokens"], np.int64)
        if _well_formed(toks, int(it["generated"]), max_new, stop, c["vocab_size"]):
            good.append(it)
        else:
            malformed += 1
    rows, ctrl_rows = [], []
    extra = {"routing_mismatch": 0.0}
    if good:
        given = _given(good, c["num_hidden_layers"])
        served = [torch.from_numpy(np.asarray(it["tokens"][: it["generated"]], np.int64)).to(
            run.device) for it in good]
        outs = []
        for m in [ref] + ([ctrl] if ctrl is not None else []):
            audio = m.audio([it["audio"] for it in good], run.device)
            seqs = [torch.cat([m.embed(pre), a, m.embed(suf), m.embed(s[:-1].cpu().numpy())])
                    for a, s in zip(audio, served)]
            lengths = [len(s) for s in served]
            if m is ref:
                outs.append(m.logits(seqs, lengths, given=given, within=ROUTING_MARGIN))
                extra = {"routing_mismatch": float(ref.mismatch) if given is not None
                         else float("inf"),
                         "routing_mismatch.share": ref.mismatch / max(1, ref.choices()),
                         "routing_mismatch.margin": ref.mismatch_margin,
                         "routing_boundary_share": ref.boundary_share(),
                         "routing_differ.margins": _largest(ref.differ)}
            else:
                outs.append(m.logits(seqs, lengths, routing=ref.used))
                extra["control.routing_mismatch"] = float(
                    _disagree(m.chosen, ref.used, ref.margins, ROUTING_MARGIN))
            del audio, seqs
        for i, s in enumerate(served):
            rows.append(judge_mod.row_numbers(outs[0][i], s, stop, 1))
            if ctrl is not None:
                ctrl_rows.append(judge_mod.control_row_numbers(outs[0][i], outs[1][i], s, stop, 1))
    out = {"malformed": float(malformed), **judge_mod.summarise(rows), **extra}
    out.update({"control." + k: v for k, v in judge_mod.summarise(ctrl_rows).items()})
    return out
