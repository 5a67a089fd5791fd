"""K2′ (permute_append_sharded) CUDA kernel against its plain version, on
the card.

Needs an NVIDIA Hopper card, nvcc and the CUDA build of PyTorch; skips
elsewhere. Imports neither JAX nor the JAX package, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fused_step_sharded_cuda.py

The planes hold one rank's rows and ``idx`` their GLOBAL source rows
(rank 1 of 2 below). K2′ moves bytes, so the kernel and the plain version
must agree BITWISE (compared as uint8) over the window [0, pos] of the write
plane, the read plane and the other layers. Refusals: rows that are not
whole samples raise; an index whose local row falls outside the shard
traps in the kernel (run in a child process: a trap ends the CUDA context).
"""

import os
import subprocess
import sys

import pytest
import torch

from whisper_tpu_torch.ops import fused_step as tf

pytestmark = pytest.mark.cuda

FP8 = torch.float8_e4m3fn
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _rand(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).mul(4).to(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _global_idx(bk: int, beam: int, row0: int, gen, device) -> torch.Tensor:
    """Beam selection's shape of permutation, numbered globally: each row's
    source is a row of its own sample, with a duplicate always."""
    src = torch.randint(0, beam, (bk,), generator=gen, device=device)
    src[1] = src[0]
    base = (torch.arange(bk, device=device) // beam) * beam
    return (row0 + base + src).to(torch.int32)


@pytest.mark.parametrize(
    "shape, dtype, beam",
    [
        ((2, 32, 10, 68, 1280), FP8, 5),  # large-v3 beam 5, rank 1 of a batch of 4 on 2
        ((2, 32, 10, 68, 1280), torch.bfloat16, 5),
        ((2, 4, 6, 40, 384), torch.float32, 3),  # tiny beam 3
        ((2, 2, 6, 17, 64), FP8, 3),  # dev: a 64-byte position
    ],
)
@pytest.mark.parametrize("parity", [0, 1])
def test_permute_append_sharded_matches_plain(card, shape, dtype, beam, parity):
    gen = torch.Generator(device=card).manual_seed(0)
    _, n_layer, bk, ctx, hd = shape
    idx = _global_idx(bk, beam, bk, gen, card)  # rank 1: global rows bk..2bk-1
    layer = n_layer - 1
    for pos in (0, 4, ctx // 2, ctx - 1):
        ck, cv = _rand(shape, dtype, gen, card), _rand(shape, dtype, gen, card)
        kn, vn = _rand((bk, hd), torch.float32, gen, card), _rand((bk, hd), torch.float32, gen, card)
        ref_k, ref_v = ck.cpu(), cv.cpu()
        tf.permute_append_sharded_reference(
            ref_k, ref_v, idx.cpu(), layer, pos, parity, kn.cpu(), vn.cpu(), beam=beam
        )
        k2, k2s = tf.launches, tf.sharded_launches
        tf.permute_append_sharded(ck, cv, idx, layer, pos, parity, kn, vn, beam=beam)
        torch.cuda.synchronize()
        assert (tf.launches, tf.sharded_launches) == (k2, k2s + 1)
        for got, ref in ((ck.cpu(), ref_k), (cv.cpu(), ref_v)):
            w = 1 - parity
            assert torch.equal(_bytes(got[w, layer, :, : pos + 1]), _bytes(ref[w, layer, :, : pos + 1]))
            assert torch.equal(_bytes(got[parity]), _bytes(ref[parity]))
            assert torch.equal(_bytes(got[w, :layer]), _bytes(ref[w, :layer]))


def test_refuses_rows_that_are_not_whole_samples(card):
    planes = torch.zeros(2, 1, 6, 4, 16, device=card)
    idx = torch.arange(6, dtype=torch.int32, device=card)
    new = torch.zeros(6, 16, device=card)
    for beam in (4, 0):
        with pytest.raises(ValueError, match="whole samples"):
            tf.permute_append_sharded(planes, planes.clone(), idx, 0, 1, 0, new, new, beam=beam)
    with pytest.raises(TypeError):  # int64 indices: the kernel reads int32
        tf.permute_append_sharded(planes, planes.clone(), idx.long(), 0, 1, 0, new, new, beam=3)


def test_out_of_range_local_index_traps(card):
    code = (
        "import torch\n"
        "from whisper_tpu_torch.ops import fused_step as tf\n"
        "planes = torch.zeros(2, 1, 6, 4, 16, device='cuda')\n"
        "idx = torch.arange(6, dtype=torch.int32, device='cuda')\n"
        "idx[0] = -1  # localises to row -1\n"
        "new = torch.zeros(6, 16, device='cuda')\n"
        "tf.permute_append_sharded(planes, planes.clone(), idx, 0, 1, 0, new, new, beam=3)\n"
        "torch.cuda.synchronize()\n"
        "print('no trap')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode != 0 and "no trap" not in out.stdout, out.stdout
    assert "CUDA error" in out.stderr or "cudaError" in out.stderr, out.stderr[-2000:]
