"""The port's engine on tensor-parallel meshes against JAX's.

gloo worlds of CPU ranks (``parallel/_dist_worker.launch``, one process per
rank) at ``dev`` dims in f32, on the meshes (1, 2) and (2, 2): the model
axis of 2 cuts the heads and MLP (``parallel/sharding.py``) and the layers
all-reduce over it (``parallel/collectives.py``). JAX's engine runs the same
weights on the same meshes in this process (conftest's 8 virtual devices),
and the port's single-process engine runs them too. For greedy with
language detection and word timestamps, beam 3 "off" (and "lineage"),
int8 weights + an fp8 KV cache under beam 3, and ``transcribe_files``, every
rank returns the same full result list, and its tokens and text EQUAL
JAX's on both meshes and the single process's; ``avg_logprob`` to rtol
1e-5 (atol 1e-5), words to 1e-4 s. A draft at k = 2 equals greedy.
"hybrid" raises on a model axis > 1, in the port and in JAX. The
collectives are counted exactly: 2 per layer per encode, 2 + 3 per layer
per decoder forward, and the alignment's one more.
"""

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import EngineConfig as JaxConfig
from whisper_tpu.decode.beam import resolve_fused as jax_resolve_fused
from whisper_tpu.engine import EngineType as JaxType
from whisper_tpu.engine import create_engine as jax_create_engine
from whisper_tpu.models.params import init_params as jax_init_params
from whisper_tpu_torch.audio.wav import write_wav
from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig
from whisper_tpu_torch.decode.beam import beam_decode, resolve_fused
from whisper_tpu_torch.engine import EngineType, create_engine
from whisper_tpu_torch.engine.serving import AsyncTranscriber
from whisper_tpu_torch.models.params import params_from_jax
from whisper_tpu_torch.parallel.mesh import Mesh
from whisper_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(2)

BASE = dict(model="dev", dtype="float32", max_new_tokens=8)
MESHES = [(1, 2), (2, 2)]
# Worker flags and the matching EngineConfig of each configuration.
CONFIGS = {
    "greedy_words": (["--word-timestamps"], dict(word_timestamps=True)),
    "beam3": (["--beam", "3", "--fused-step", "off,lineage"], dict(beam_size=3, fused_step="off")),
    "int8_fp8": (
        ["--beam", "3", "--quantization", "int8", "--kv-cache-dtype", "float8_e4m3fn"],
        dict(beam_size=3, quantization="int8", kv_cache_dtype="float8_e4m3fn"),
    ),
    "draft": (["--draft-model", "dev", "--k-draft", "2"], None),
}
DEV = MODEL_DIMS["dev"]
LAYERS = DEV.n_text_layer


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000.0
    x = 0.2 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _batch():
    x = np.zeros((4, 16_000 * 4), np.float32)
    for i, s in enumerate((4.0, 2.5, 3.5, 1.5)):
        a = _audio(s, i + 1)
        x[i, : len(a)] = a
    return x


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's dev weights (PRNGKey 5: rows that differ), and the same for
    the port in a file."""
    tree = jax.tree.map(np.asarray, jax_init_params(JaxConfig(**BASE).dims(), jax.random.PRNGKey(5)))
    path = str(tmp_path_factory.mktemp("tp_weights") / "params.pt")
    torch.save(params_from_jax(tree), path)
    return tree, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_files")
    paths = []
    for i, s in enumerate((3.0, 1.5, 2.5)):
        p = str(d / f"u{i}.wav")
        write_wav(p, _audio(s, i + 1))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def runs(weights, files, tmp_path_factory):
    """Every configuration on both meshes: {(mesh, name): reports}."""
    d = tmp_path_factory.mktemp("tp_runs")
    np.save(d / "batch.npy", _batch())
    common = ["--params", weights[1], "--model", "dev", "--device", "cpu", "--dtype", "float32",
              "--max-new", "8", "--threads", "1"]
    out = {}
    for mesh in MESHES:
        n = mesh[0] * mesh[1]
        spec = ["--mesh", f"{mesh[0]},{mesh[1]}"]
        for name, (flags, _) in CONFIGS.items():
            out[mesh, name] = launch(n, ["--npy", str(d / "batch.npy"), *common, *spec, *flags],
                                     str(d), timeout=180)
        out[mesh, "files"] = launch(n, ["--paths", ",".join(files), *common, *spec], str(d),
                                    timeout=180)
    return out


def _rows(results):
    return [
        {"tokens": [int(t) for t in r.tokens[: r.length]], "length": int(r.length), "text": r.text}
        for r in results
    ]


def _core(got):
    return [{k: g[k] for k in ("tokens", "length", "text")} for g in got]


def _jax(tree, mesh, **kw):
    return jax_create_engine(JaxType.MONOLITH, JaxConfig(**BASE, mesh_shape=mesh, **kw), params=tree)


def _single(tree, **kw):
    return create_engine(EngineType.MONOLITH, EngineConfig(**BASE, **kw),
                         params=params_from_jax(tree), device="cpu")


def _only_run(rep, mode="auto"):
    return rep["runs"][mode]


def test_every_rank_returns_the_same_results_with_half_the_weights(runs):
    for (mesh, name), reps in runs.items():
        assert [r["rank"] for r in reps] == list(range(mesh[0] * mesh[1]))
        assert all(r["mesh"] == list(mesh) for r in reps)
        for mode in reps[0]["runs"]:
            results = [r["runs"][mode]["results"] for r in reps]
            assert all(res == results[0] for res in results), (mesh, name, mode)
        # The ranks of a model group hold different halves of the model.
        assert reps[0]["params_checksum"] != reps[1]["params_checksum"]
        if mesh == (2, 2):  # rank r and r + 2 hold the same half
            assert reps[0]["params_checksum"] == reps[2]["params_checksum"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["greedy_words", "beam3", "int8_fp8"])
def test_tp_engine_equal_to_jax_and_single_process(weights, runs, mesh, name):
    tree, _ = weights
    kw = CONFIGS[name][1]
    x = _batch()
    ref = _jax(tree, mesh, **kw).transcribe_batch(x)
    single = _single(tree, **kw).transcribe_batch(x)
    assert _rows(single) == _rows(ref)
    for rep in runs[mesh, name]:
        got = _only_run(rep, "off" if name == "beam3" else "auto")["results"]
        assert _core(got) == _rows(ref)
        assert len({tuple(g["tokens"]) for g in got}) > 1  # the rows differ: a real check
        for g, r in zip(got, ref):
            if r.avg_logprob is not None:
                np.testing.assert_allclose(g["avg_logprob"], r.avg_logprob, rtol=1e-5, atol=1e-5)
            if r.words is not None:
                assert [w[0] for w in g["words"]] == [w.word for w in r.words]
                np.testing.assert_allclose(
                    [w[1:] for w in g["words"]], [[w.start, w.end] for w in r.words], atol=1e-4
                )
    if name == "greedy_words":  # detection ran: the language is the detected one
        assert all(r.language for r in ref)
        assert "detect" in runs[mesh, name][0]["runs"]["auto"]["collectives"]["by_stage"]
    if name == "beam3":  # lineage equals the eager step on the mesh
        for rep in runs[mesh, name]:
            lin, off = rep["runs"]["lineage"]["results"], rep["runs"]["off"]["results"]
            assert _core(lin) == _core(off)
            np.testing.assert_allclose([g["avg_logprob"] for g in lin],
                                       [g["avg_logprob"] for g in off], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_transcribe_files_equal_to_jax(weights, files, runs, mesh):
    tree, _ = weights
    expected = _rows(_jax(tree, mesh, audio_ctx=None).transcribe_files(files))
    assert _rows(_single(tree, audio_ctx=None).transcribe_files(files)) == expected
    for rep in runs[mesh, "files"]:
        run = _only_run(rep)
        assert rep["audio_ctx"] is None  # "auto" without the whole batch
        assert _core(run["results"]) == expected
        assert run["probe_single"] == expected[0]["tokens"]


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_draft_equals_greedy(runs, mesh):
    for spec, greedy in zip(runs[mesh, "draft"], runs[mesh, "greedy_words"]):
        assert _core(_only_run(spec)["results"]) == _core(_only_run(greedy)["results"])
        assert "window" in _only_run(spec)["collectives"]["by_stage"]


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_counted_exactly(runs, mesh):
    for rep in runs[mesh, "greedy_words"]:
        run = _only_run(rep)
        per_forward = 2 + 3 * LAYERS
        assert run["collectives"]["by_stage"] == {
            "encode": 2 * DEV.n_audio_layer,  # one encode of the batch
            "detect": per_forward,
            "prefill": per_forward,
            "step": per_forward * run["steps"],
            "align": per_forward,  # embedding, 3 per layer, the heads' sum
        }
        assert run["collectives"]["calls"] == sum(run["collectives"]["by_stage"].values())


BF16_CONFIGS = {
    "greedy": ([], {}, "auto"),
    "beam3": (["--beam", "3", "--fused-step", "off"], dict(beam_size=3, fused_step="off"), "off"),
}


@pytest.mark.parametrize("name", list(BF16_CONFIGS))
def test_tp_bf16_equal_to_single_process(weights, tmp_path, name):
    """bf16 on (1, 2): a row-parallel product is summed from f32 partials
    and rounded once, where one process rounds its product, then its sum
    with the bias: the tokens are the single process's, ``avg_logprob``
    within that one rounding (rtol 1e-3)."""
    tree, path = weights
    flags, kw, mode = BF16_CONFIGS[name]
    np.save(tmp_path / "batch.npy", _batch())
    reps = launch(2, ["--npy", str(tmp_path / "batch.npy"), "--params", path, "--model", "dev",
                      "--device", "cpu", "--dtype", "bfloat16", "--max-new", "8", "--threads", "1",
                      "--mesh", "1,2", *flags], str(tmp_path), timeout=180)
    single = create_engine(EngineType.MONOLITH, EngineConfig(**dict(BASE, dtype="bfloat16"), **kw),
                           params=params_from_jax(tree), device="cpu").transcribe_batch(_batch())
    for rep in reps:
        got = _only_run(rep, mode)["results"]
        assert _core(got) == _rows(single)
        if name == "beam3":
            np.testing.assert_allclose([g["avg_logprob"] for g in got],
                                       [r.avg_logprob for r in single], rtol=1e-3)


_LINEAR_RANK = """
import sys
import numpy as np
import torch
from whisper_tpu_torch.models.layers import linear
from whisper_tpu_torch.parallel import multihost
from whisper_tpu_torch.parallel.mesh import make_mesh

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
multihost.initialize(f"127.0.0.1:{port}", 2, rank)
mesh = make_mesh((1, 2), device="cpu")
g = torch.Generator().manual_seed(0)
x = torch.randn(2, 5, 64, generator=g).to(torch.bfloat16)
w = (torch.randn(64, 48, generator=g) / 8).to(torch.bfloat16)
w_q = torch.randint(-127, 128, (64, 48), generator=g, dtype=torch.int8)
w_s, b = torch.rand(48, generator=g) / 100, torch.randn(48, generator=g)
rows = slice(32 * rank, 32 * (rank + 1))  # this rank's half of d_in
xs = x[..., rows]
saved = {
    "float": linear({"w": w[rows], "b": b}, xs, tp=mesh),
    "int8": linear({"w_q": w_q[rows], "w_s": w_s, "b": b}, xs, tp=mesh),
    "float_partial": torch.matmul(xs.float(), w[rows].float()),
    "int8_partial": torch.matmul(xs.float(), w_q[rows].float()),
    "float_single": linear({"w": w, "b": b}, x),
    "int8_single": linear({"w_q": w_q, "w_s": w_s, "b": b}, x),
    "w_s": w_s, "b": b,
}
torch.save(saved, out)
"""


def test_row_parallel_linear_sums_f32_partials_in_bf16(tmp_path):
    """A bf16 row-parallel ``linear`` on two gloo ranks, float and int8
    weights: every rank returns exactly bf16((p0 + p1) · s + b) of the two
    ranks' f32 partial products (no bf16 rounding before the sum), and the
    single process's result to within its one extra bf16 rounding."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _LINEAR_RANK, str(r), port, outs[r]],
                              cwd=repo, env=env, stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (torch.load(o) for o in outs)
    for kind in ("float", "int8"):
        summed = r0[f"{kind}_partial"] + r1[f"{kind}_partial"]
        if kind == "int8":
            summed = summed * r0["w_s"]
        want = (summed + r0["b"]).to(torch.bfloat16)
        assert torch.equal(r0[kind], want) and torch.equal(r1[kind], want), kind
        # One process rounds its product (to half an ulp of the product)
        # before the bias: at most that and the two final roundings apart.
        single = r0[f"{kind}_single"].float()
        bound = torch.finfo(torch.bfloat16).eps * (summed.abs() + single.abs())
        assert bool(((want.float() - single).abs() <= bound).all()), kind


def test_hybrid_raises_on_a_model_axis(weights):
    dims = MODEL_DIMS["dev"]
    for fused in ("hybrid",):
        with pytest.raises(ValueError, match="tensor-parallel"):
            resolve_fused(fused, dims, "cpu", torch.float32, tp=2)
        with pytest.raises(ValueError):
            jax_resolve_fused(fused, JaxConfig(**BASE).dims(), tp=2)
    for fused in ("auto", True):
        assert resolve_fused(fused, dims, "cuda", torch.bfloat16, tp=2) == "off"
        assert jax_resolve_fused(fused, JaxConfig(**BASE).dims(), tp=2) != "hybrid"
    # Through the decode entry point, before any collective is needed.
    mesh = Mesh({"data": 1, "model": 2}, ("data", "model"), 0, torch.device("cpu"), 0)
    with pytest.raises(ValueError, match="tensor-parallel"):
        beam_decode(
            {}, torch.zeros(1, 4, 64), torch.zeros(1, 4, dtype=torch.long), dims, eot=0,
            max_new_tokens=2, beam_size=2, fused="hybrid", mesh=mesh,
        )
    with pytest.raises(ValueError):
        _jax(weights[0], (1, 2), beam_size=3, fused_step="hybrid").transcribe_batch(_batch()[:2])


def test_sharded_assets_refused_off_their_mesh(weights):
    """Assets that hold one rank's slice build no engine without that
    rank's place on a model axis."""
    import dataclasses

    engine = _single(weights[0])
    sliced = dataclasses.replace(engine.assets, shard=(0, 2))
    with pytest.raises(ValueError, match="model slice"):
        type(engine)(sliced, engine.config, device="cpu")


def test_serving_refuses_a_tensor_parallel_engine():
    class _Engine:  # an engine as a rank of a (1, 2) mesh sees it
        mesh = Mesh({"data": 1, "model": 2}, ("data", "model"), 0, torch.device("cpu"), 0)
        config = EngineConfig(**BASE, mesh_shape=(1, 2))

    with pytest.raises(NotImplementedError, match="AsyncTranscriber"):
        AsyncTranscriber(_Engine())


def test_cli_under_torchrun_on_a_model_axis(weights, files, tmp_path):
    """``--mesh 1,2`` under ``torchrun``: each of the two ranks prints the
    single-process CLI's transcript of the file.

    The ranks meet on the launcher's c10d store, bound to a port of the
    kernel's choosing on 127.0.0.1 (``--local-addr``: no host-name lookup
    for the workers' store address; gloo on the loopback device), and each
    rank's standard output goes to a file of its own (``--redirects 1``), so
    that each rank's transcript is read whole rather than as two ranks'
    writes interleaved on one pipe."""
    import os
    import subprocess
    import sys

    from whisper_tpu_torch.utils.checkpoint import save_params

    tree, _ = weights
    ckpt = str(tmp_path / "dev.npz")
    save_params(ckpt, params_from_jax(tree), MODEL_DIMS["dev"])
    args = ["transcribe", files[0], "--checkpoint", ckpt, "--device", "cpu", "--dtype", "float32",
            "--max-new-tokens", "6"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo, GLOO_SOCKET_IFNAME="lo")
    logs = tmp_path / "ranks"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "2",
         "--rdzv-backend", "c10d", "--rdzv-endpoint", "127.0.0.1:0", "--local-addr", "127.0.0.1",
         "--redirects", "1", "--log-dir", str(logs),
         "-m", "whisper_tpu_torch.cli", *args, "--mesh", "1,2"],
        capture_output=True, text=True, timeout=180, cwd=repo, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    single = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.cli", *args],
                            capture_output=True, text=True, timeout=180, cwd=repo, env=env)
    assert single.returncode == 0, single.stderr[-3000:]
    ranks = sorted(logs.glob("*/attempt_0/*/stdout.log"), key=lambda p: p.parent.name)
    assert [p.parent.name for p in ranks] == ["0", "1"], ranks
    assert single.stdout.strip() and all(p.read_text() == single.stdout for p in ranks)
