"""A configuration's model family is found by file: weights, reference and
judge come from ``families/<family>.py``.

* The Whisper family reads what the harness read before families existed:
  the same weights bit for bit, and, in each cell, the same ``checks`` as a
  direct call of the Whisper reference and its judge on the same served
  requests.
* A second family is added as a new configuration would add one, by new
  files and new entries only: a copy of the benchmark gains a toy
  decoder-only language model over projected audio frames (its family,
  configuration, traffic, driver and limits), runs correct on the CPU,
  comes out not correct with a token altered where it is produced, and
  leaves every file it found unchanged. A family that has no file stops
  the run before any weights are drawn.
"""

import hashlib
import json
import shutil

import pytest
import torch

from port_bench import run as R
from port_bench.common import weights
from port_bench.reference import judge as judge_mod
from port_bench.reference.whisper import Whisper
from port_bench.tests.conftest import TINY
from port_bench.tests.test_bench_faults import CELLS as FAULT_CELLS

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
SEED = 2147483659  # more than 32 signed bits hold: a run takes any such seed
CELLS = dict(FAULT_CELLS, **{"large-v3-turbo.offline-short": {
    "rows": 4, "max_new_tokens": 8, "pool": 1, "judge_requests": 4}})


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_whisper_family_draws_the_same_weights(entry):
    config = {**json.loads((R.ROOT / entry["file"]).read_text()), **TINY}
    family = R.family_module(config)
    ours = list(_leaves(family.make_params(config, SEED, "cpu")))
    theirs = list(_leaves(weights.make_params(config, SEED, "cpu")))
    assert len(ours) == len(theirs)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_whisper_family_judges_as_the_reference_did(monkeypatch, cell):
    judged = []
    real_sample = R.sample

    def keep(items, n, seed):
        judged.append(real_sample(items, n, seed))
        return judged[-1]

    monkeypatch.setattr(R, "sample", keep)
    run = R.prepare(cell, SEED, "cpu", {"config": TINY, "traffic": CELLS[cell]})
    run.log = lambda msg: None
    res = R.execute(run, 0.5, False)
    assert res["correct"] and len(judged) == 1 and judged[0]

    ref = run.config["reference"]
    direct = judge_mod.judge(
        Whisper(run.params, run.config, weights=ref["weights"], kv=ref["kv"]), judged[0],
        run.config, run.config["engine"]["beam_size"], run.traffic["max_new_tokens"], run.device)
    want = {"failed": {"value": 0, "limit": 0}}
    want.update({name: {"value": direct.get(name, float("inf")), "limit": limit}
                 for name, limit in run.limits.items()})
    assert res["checks"] == want


# --- a second family, added by new files and entries only ----------------------
TOY_FAMILY = '''"""A toy family: frames of the audio through a tanh encoder and a linear
projector, then a two-layer decoder-only language model (RMSNorm, causal
attention, SwiGLU, untied head) that continues them greedily from BOS."""

import numpy as np
import torch
import torch.nn.functional as F


def check(config):
    assert config["d_model"] % config["n_heads"] == 0 and config["n_layers"] == 2


def shapes(c):
    d, f = c["d_model"], c["ffn_dim"]
    out = {"enc": (c["frame"], c["enc_dim"]), "proj": (c["enc_dim"], d),
           "emb": (c["vocab_size"], d), "norm": (d,), "head": (d, c["vocab_size"])}
    for i in range(c["n_layers"]):
        out.update({f"{i}.norm1": (d,), f"{i}.qkv": (d, 3 * d), f"{i}.o": (d, d),
                    f"{i}.norm2": (d,), f"{i}.up": (d, 2 * f), f"{i}.down": (f, d)})
    return out


def make_params(config, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    p = {}
    for name, shape in shapes(config).items():
        x = torch.randn(shape, generator=gen, device=device)
        p[name] = 1 + 0.1 * x if len(shape) == 1 else x * shape[0] ** -0.5
    return p


def frames(c, audio):
    n = c["n_frames"] * c["frame"]
    return torch.from_numpy(np.asarray(audio[:n], np.float32)).view(c["n_frames"], c["frame"])


def _rms(x, g):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * g


def forward(p, c, fr, tokens):
    """Teacher-forced logits [len(tokens), V] after the projected frames."""
    x = torch.cat([torch.tanh(fr @ p["enc"]) @ p["proj"], p["emb"][tokens]])
    n, d, h = x.shape[0], c["d_model"], c["n_heads"]
    keep = torch.ones(n, n, dtype=torch.bool).tril()
    for i in range(c["n_layers"]):
        q, k, v = (_rms(x, p[f"{i}.norm1"]) @ p[f"{i}.qkv"]).view(n, 3, h, d // h).unbind(1)
        a = torch.einsum("qhd,khd->hqk", q, k) * (d // h) ** -0.5
        a = a.masked_fill(~keep, float("-inf")).softmax(-1)
        x = x + torch.einsum("hqk,khd->qhd", a, v).reshape(n, d) @ p[f"{i}.o"]
        g, u = (_rms(x, p[f"{i}.norm2"]) @ p[f"{i}.up"]).chunk(2, -1)
        x = x + (F.silu(g) * u) @ p[f"{i}.down"]
    return (_rms(x, p["norm"]) @ p["head"])[-len(tokens):]


def judge(run, items, control=False):
    c, p = run.config, run.params
    low = {k: v.bfloat16().float() for k, v in p.items()}  # the control: bfloat16 weights
    gaps, ctrl_gaps, malformed = [0.0], [0.0], 0
    for it in items:
        toks = list(it["tokens"])
        if (toks[0] != c["bos"] or it["length"] != len(toks)
                or len(toks) != run.traffic["max_new_tokens"] + 1
                or not all(0 <= t < c["vocab_size"] for t in toks)):
            malformed += 1
            continue
        fr, inp, served = frames(c, it["audio"]), torch.tensor(toks[:-1]), torch.tensor(toks[1:])
        logits = forward(p, c, fr, inp)
        best = logits.max(-1).values
        gaps.append(float((best - logits.gather(1, served[:, None])[:, 0]).max()))
        if control:
            first = forward(low, c, fr, inp).argmax(-1)
            ctrl_gaps.append(float((best - logits.gather(1, first[:, None])[:, 0]).max()))
    out = {"malformed": float(malformed), "top1_gap": max(gaps)}
    if control:
        out["control.top1_gap"] = max(ctrl_gaps)
    return out
'''

TOY_DRIVER = '''"""The toy family's program: greedy decodes with a per-layer K/V cache, one
batch of seeded clips after another."""

import time

import torch
import torch.nn.functional as F

from port_bench.drivers.common import rng


def pick(logits):
    return int(logits.argmax())


def _rms(x, g):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * g


def _layers(p, c, x, cache):
    """New rows ``x`` [n, d] through both layers, appending to ``cache``."""
    d, h = c["d_model"], c["n_heads"]
    for i in range(c["n_layers"]):
        q, k, v = (_rms(x, p[f"{i}.norm1"]) @ p[f"{i}.qkv"]).view(len(x), 3, h, d // h).unbind(1)
        ks, vs = cache.setdefault(i, ([], []))
        ks.append(k)
        vs.append(v)
        k, v = torch.cat(ks), torch.cat(vs)
        a = torch.einsum("qhd,khd->hqk", q, k) * (d // h) ** -0.5
        a = a.masked_fill(~torch.ones(len(x), len(k), dtype=torch.bool).tril(len(k) - len(x)),
                          float("-inf"))
        x = x + torch.einsum("hqk,khd->qhd", a.softmax(-1), v).reshape(len(x), d) @ p[f"{i}.o"]
        g, u = (_rms(x, p[f"{i}.norm2"]) @ p[f"{i}.up"]).chunk(2, -1)
        x = x + (F.silu(g) * u) @ p[f"{i}.down"]
    return _rms(x[-1], p["norm"]) @ p["head"]


def decode(p, c, audio, max_new):
    n = c["n_frames"] * c["frame"]
    fr = torch.from_numpy(audio[:n]).view(c["n_frames"], c["frame"])
    toks, cache = [c["bos"]], {}
    x = torch.cat([torch.tanh(fr @ p["enc"]) @ p["proj"], p["emb"][toks]])
    for _ in range(max_new):
        toks.append(pick(_layers(p, c, x, cache)))
        x = p["emb"][toks[-1:]]
    return toks


def setup(run):
    c, t = run.config, run.traffic
    audio = rng(run.seed, 100).standard_normal((t["rows"], c["n_frames"] * c["frame"]))
    return {"audio": audio.astype("float32")}


def measure(run, state, seconds, trace):
    t, items, t0 = run.traffic, [], time.perf_counter()
    while not items or time.perf_counter() - t0 < seconds:
        for row in state["audio"]:
            toks = decode(run.params, run.config, row, t["max_new_tokens"])
            items.append({"audio": row, "tokens": toks, "length": len(toks)})
    wall = time.perf_counter() - t0
    audio_s = len(items) * state["audio"].shape[1] / 16_000
    return {"attempted": len(items), "failed": 0, "items": items, "layer": {},
            "e2e": {"audio_s_per_s": audio_s / wall}, "notes": {"requests": len(items)}}


def close(state):
    state.clear()
'''

TOY_CONFIG = {"family": "toy_lm", "source": "a toy model of the harness's own tests",
              "reduced": [], "d_model": 32, "n_heads": 4, "n_layers": 2, "ffn_dim": 64,
              "vocab_size": 97, "frame": 160, "enc_dim": 24, "n_frames": 8, "bos": 1}
TOY_TRAFFIC = {"driver": "toy_batches", "rows": 3, "max_new_tokens": 6, "judge_requests": 4}
TOY_CELL = "toy.greedy.batches"


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_config(copy, name: str, config: dict, cell: str) -> None:
    """A configuration and one cell on it, as new files and new entries."""
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": config["source"],
                             "file": f"port_bench/configs/{name}.json", "reduced": [],
                             "why": "a second model family"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": "toy-batches",
                               "chips": 1, "why": "toy greedy batches"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "audio_s_per_s")
    rate["workloads"].append(cell)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (copy / "port_bench" / "configs" / f"{name}.json").write_text(json.dumps(config))
    (copy / "port_bench" / "workloads" / f"{cell}.json").write_text(
        json.dumps({"limits": {"malformed": 0, "top1_gap": 1e-3}}))


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A copy of the benchmark with the toy family's cell added; yields the
    copy and the hashes of the files it held before."""
    copy = tmp_path / "checkout"
    shutil.copytree(R.BENCH, copy / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _hashes(copy / "port_bench")
    bench_before = json.loads((copy / "BENCHMARK.json").read_text())
    pb = copy / "port_bench"
    (pb / "families" / "toy_lm.py").write_text(TOY_FAMILY)
    (pb / "drivers" / "toy_batches.py").write_text(TOY_DRIVER)
    (pb / "traffic" / "toy-batches.json").write_text(json.dumps(TOY_TRAFFIC))
    _add_config(copy, "toy.greedy", TOY_CONFIG, TOY_CELL)
    monkeypatch.setattr(R, "BENCH", pb)
    monkeypatch.setattr(R, "ROOT", copy)
    yield copy
    after = _hashes(pb)
    assert {k: after.get(k) for k in before} == before  # no file it found changed
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    names = {"toy.greedy", TOY_CELL, "toy.bad", "toy.bad.batches"}
    for key in ("configs", "workloads"):
        bench[key] = [e for e in bench[key] if e["name"] not in names]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in names]
    assert bench == bench_before  # its entries only added to


def _toy_run():
    run = R.prepare(TOY_CELL, SEED, "cpu")
    run.log = lambda msg: None
    return run, R.execute(run, 0.2, False)


def test_toy_family_is_correct(toy):
    run, res = _toy_run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert res["checks"]["top1_gap"]["value"] < 1e-4 and res["attempted"] >= 3
    run.family.check(run.config)
    item = {"audio": torch.zeros(1280).numpy(), "tokens": [1] * 7, "length": 7}
    assert set(run.family.judge(run, [item], control=True)) == {
        "malformed", "top1_gap", "control.top1_gap"}


def test_toy_family_fault_is_not_correct(toy, monkeypatch):
    """A token altered where the toy program picks it."""
    real_load = R.load_module

    def load(path):
        mod = real_load(path)
        if path.name == "toy_batches.py":
            real_pick, calls = mod.pick, [0]

            def altered(logits):
                calls[0] += 1
                tok = real_pick(logits)
                return (tok + 5) % logits.shape[-1] if calls[0] % 4 == 3 else tok

            mod.pick = altered
        return mod

    monkeypatch.setattr(R, "load_module", load)
    _, res = _toy_run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["top1_gap"]["value"] > 1e-3


@pytest.mark.parametrize("family", ["no_such_family", "../run", 7])
def test_unknown_family_stops_the_run(toy, family):
    """In ``prepare``: before a driver is loaded or any weights are drawn."""
    _add_config(toy, "toy.bad", dict(TOY_CONFIG, family=family), "toy.bad.batches")
    with pytest.raises(SystemExit) as stop:
        R.prepare("toy.bad.batches", SEED, "cpu")
    assert "no model family" in str(stop.value) and "\n" not in str(stop.value)
