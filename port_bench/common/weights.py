"""Random Whisper weights drawn from the run's seed, on the card, in the
type they are served in, in the program's parameter layout.

The layout is the one ``whisper_tpu_torch.models.params`` documents for
``create_engine(..., params=...)``: nested dicts, one dict per block in a
list, linear weights ``[d_in, d_out]``, conv weights ``[c_out, c_in,
width]``, ``decoder.tok_emb`` both embedding and unembedding. Every leaf
is a view into one flat buffer filled by a few large ``randn`` calls on a
generator seeded with the run's seed; each leaf is then scaled in place.
Matrices get ``std = fan_in ** -0.5`` (activations keep their size through
the 32 layers), layer-norm gains ``1 + 0.1·n`` and biases ``0.02·n`` (so
that a reference that drops a gain or a bias reads wrong), the positional
table ``0.01·n``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 27  # elements per randn call


def _layout(dims: Dict[str, int]) -> List[Tuple[tuple, tuple, str, float]]:
    """[(key path, shape, kind, std)] of every leaf, for ``dims``."""
    d, d_ff = dims["d_model"], dims["encoder_ffn_dim"]
    leaves: List[Tuple[tuple, tuple, str, float]] = []

    def dense(path, d_in, d_out, bias=True):
        leaves.append((path + ("w",), (d_in, d_out), "w", d_in ** -0.5))
        if bias:
            leaves.append((path + ("b",), (d_out,), "b", 0.02))

    def ln(path, n):
        leaves.append((path + ("g",), (n,), "g", 0.1))
        leaves.append((path + ("b",), (n,), "b", 0.02))

    def attn(path):
        dense(path + ("q",), d, d)
        dense(path + ("k",), d, d, bias=False)  # Whisper: no K bias
        dense(path + ("v",), d, d)
        dense(path + ("o",), d, d)

    def mlp(path, ff):
        dense(path + ("fc1",), d, ff)
        dense(path + ("fc2",), ff, d)

    def conv(path, c_in, c_out):
        leaves.append((path + ("w",), (c_out, c_in, 3), "w", (3 * c_in) ** -0.5))
        leaves.append((path + ("b",), (c_out,), "b", 0.02))

    e = ("encoder",)
    conv(e + ("conv1",), dims["num_mel_bins"], d)
    conv(e + ("conv2",), d, d)
    for i in range(dims["encoder_layers"]):
        b = e + ("blocks", i)
        ln(b + ("ln1",), d)
        attn(b + ("attn",))
        ln(b + ("ln2",), d)
        mlp(b + ("mlp",), d_ff)
    ln(e + ("ln_post",), d)
    t = ("decoder",)
    leaves.append((t + ("tok_emb",), (dims["vocab_size"], d), "w", d ** -0.5))
    leaves.append((t + ("pos_emb",), (dims["max_target_positions"], d), "w", 0.01))
    for i in range(dims["decoder_layers"]):
        b = t + ("blocks", i)
        ln(b + ("ln1",), d)
        attn(b + ("attn",))
        ln(b + ("ln2",), d)
        attn(b + ("cross",))
        ln(b + ("ln3",), d)
        mlp(b + ("mlp",), dims["decoder_ffn_dim"])
    ln(t + ("ln",), d)
    return leaves


def _place(tree: dict, path: tuple, value) -> None:
    """``tree[path[0]][path[1]]... = value``, making dicts and block lists
    (an int key is a block's index) on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make_params(dims: Dict[str, int], seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree for the published sizes ``dims`` (Hugging Face
    config keys), drawn from ``seed`` on ``device``."""
    leaves = _layout(dims)
    total = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        flat[start:start + n] = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, kind, std in leaves:
        n = int(torch.Size(shape).numel())
        leaf = flat[off:off + n].view(shape)
        off += n
        leaf.mul_(std)
        if kind == "g":
            leaf.add_(1.0)
        _place(tree, path, leaf)
    return tree


def n_params(dims: Dict[str, int]) -> int:
    return sum(int(torch.Size(shape).numel()) for _, shape, _, _ in _layout(dims))
