"""The ``uni_moe`` family and its cell, on the CPU at the program's
``uni-moe-dev`` sizes (the published configuration's shape, small):

* ``check`` holds the file's sizes to the program's table, and refuses a
  changed width; ``make_params`` draws the same weights bit for bit from
  one seed, other weights from another, in the program's layout;
* a run of the cell through ``run.execute`` is correct, and comes out not
  correct with a token altered where the program produces it, with one
  routed expert's output left out, with a decode step that leaves its KV
  cache unchanged (``top1_gap``) and with a router that stops at another
  top-p (``routing_mismatch``), all under the cell's own limits;
* the cell's configuration, traffic, driver, limits and metric readers are
  found by name, and every new metric reads nothing from an empty layer.
"""

import json

import pytest
import torch

from port_bench import run as R

CELL = "uni-moe-2.0-omni.offline-lm-20s"
SEED = 2147483659
DEV = dict(program_model="uni-moe-dev", hidden_size=112, num_hidden_layers=2,
           num_attention_heads=7, num_key_value_heads=1, vocab_size=512,
           dynamic_intermediate_size=64, shared_intermediate_size=24, stop_token_id=511,
           whisper_hidden_size=64, prompt={"prefix_ids": 16, "suffix_ids": 16, "id_high": 500},
           tower={"d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 2,
                  "encoder_ffn_dim": 256, "num_mel_bins": 128, "max_source_positions": 1500})
TRAFFIC = {"rows": 8, "clip_seconds": [0.5, 4.0], "max_new_tokens": 32, "pool": 1,
           "judge_requests": 8}
# The runs are held to the cell's own limits, set at the published sizes:
# at these (2 layers) sound runs read a top1_gap of 0.01-0.03.
NEW_METRICS = ("moe_expert_roofline.lm", "moe_null_share.lm", "lm_prefill_device_ms.lm", "mfu.lm")


def _config():
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "uni-moe-2.0-omni.greedy")
    return json.loads((R.ROOT / entry["file"]).read_text())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def test_check_holds_the_file_to_the_program():
    cfg = _config()
    family = R.family_module(cfg)
    family.check(cfg)  # the published sizes
    family.check({**cfg, **DEV})
    with pytest.raises(AssertionError):
        family.check({**cfg, "dynamic_intermediate_size": 9472})


def test_make_params_bitwise_by_seed():
    cfg = {**_config(), **DEV}
    family = R.family_module(cfg)
    a, b = (list(_leaves(family.make_params(cfg, SEED, "cpu"))) for _ in range(2))
    c = list(_leaves(family.make_params(cfg, SEED + 1, "cpu")))
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    p = family.make_params(cfg, SEED, "cpu")
    blk = p["blocks"][0]
    assert tuple(blk["experts"]["w_gate"].shape) == (4, 112, 64)
    assert blk["gate"].dtype == torch.float32 and p["head"].dtype == torch.bfloat16
    assert tuple(p["tower"]["encoder"]["conv1"]["w"].shape) == (64, 128, 3)


def _run(seconds=0.5):
    run = R.prepare(CELL, SEED, "cpu", {"config": DEV, "traffic": TRAFFIC})
    run.log = lambda msg: None
    return R.execute(run, seconds, False)


def test_cell_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert res["attempted"] >= 4


def test_token_altered_is_not_correct(monkeypatch):
    from whisper_tpu_torch.decode import greedy

    real = greedy.lm_greedy_decode

    def altered(*a, **k):
        tokens, lengths = real(*a, **k)
        tokens[:, 3] = (tokens[:, 3] + 7) % 500
        return tokens, lengths

    monkeypatch.setattr(greedy, "lm_greedy_decode", altered)
    res = _run()
    assert not res["correct"], res["checks"]


def test_routed_expert_left_out_is_not_correct(monkeypatch):
    from whisper_tpu_torch.models import audio_lm

    real = audio_lm.moe_experts

    def without_first(x, expert, weight, *w):
        return real(x, torch.where(expert == 0, w[0].shape[0], expert), weight, *w)

    monkeypatch.setattr(audio_lm, "moe_experts", without_first)
    res = _run()
    assert not res["correct"], res["checks"]


def test_router_changed_is_not_correct(monkeypatch):
    """A program whose router stops at top-p 0.5 picks one expert where the
    reference picks two, well outside the margin: ``routing_mismatch``."""
    import dataclasses

    from whisper_tpu_torch.models import audio_lm

    real = audio_lm.route

    def lower_top_p(gate, h, dims, valid=None):
        return real(gate, h, dataclasses.replace(dims, top_p=0.5), valid)

    monkeypatch.setattr(audio_lm, "route", lower_top_p)
    res = _run()
    assert res["checks"]["routing_mismatch"]["value"] > 0 and not res["correct"], res["checks"]


def test_step_that_leaves_its_cache_unchanged_is_not_correct(monkeypatch):
    """A decode step that writes its keys and values into a copy of the
    cache: each step attends to its own position and the prefix only."""
    from whisper_tpu_torch.models import audio_lm

    real = audio_lm.step

    def stale(params, tok, at, pad, cache, *a, **k):
        return real(params, tok, at, pad, {n: c.clone() for n, c in cache.items()}, *a, **k)

    monkeypatch.setattr(audio_lm, "step", stale)
    res = _run()
    assert not res["correct"], res["checks"]


def test_cell_files_found_by_name():
    run = R.prepare(CELL, 1, "cpu")
    assert run.traffic["driver"] == "audio_lm_batches" and run.traffic["rows"] == 64
    assert run.config["family"] == "uni_moe" and run.family.__name__.endswith("uni_moe")
    assert set(run.limits) == {"malformed", "routing_mismatch", "top1_gap"}
    names = {m["name"] for m in run.per_layer}
    assert set(NEW_METRICS) | {"device_idle.offline", "encoder_device_ms.offline",
                               "decode_graph_share.offline"} == names
    for name in NEW_METRICS:
        assert R.load_module(R.BENCH / "metrics" / f"{name}.py").read({}) is None
