"""Byte-level BPE text encoder: text → token ids.

Counterpart of ``whisper_tpu/tokenizer/bpe.py`` (``encode_text``,
``encode_initial_prompt``), for ``EngineConfig.initial_prompt``. Whisper's
tokenizers are tiktoken-format BPE, where a token's id is its merge rank,
so byte-pair encoding runs directly against the ``Vocab``'s bytes → id
map: repeatedly merge the adjacent pair whose concatenation has the lowest
id (tiktoken's ``byte_pair_merge``), with no merges file.

Pre-tokenization is GPT-2's split pattern, shared by every Whisper
tokenizer::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

The JAX package runs it with the ``regex`` package (for ``\\p{L}`` and
``\\p{N}``); the port does not depend on it. :func:`split` is that pattern
written out as a scanner: the alternatives in the pattern's order at each
position, ``\\p{L}`` and ``\\p{N}`` as ``unicodedata`` categories L* and
N*, ``\\s`` as Unicode's White_Space (``str.isspace`` without the
separators U+001C–U+001F, which ``regex`` does not count), and the
backtracking of ``\\s+(?!\\S)`` (a whitespace run before a non-space gives
its last character to the next piece).
"""

from __future__ import annotations

import unicodedata
from typing import Iterator, List

from whisper_tpu_torch.tokenizer.vocab import Vocab

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")  # str.isspace, not White_Space
_NO_RANK = 1 << 62


def _kind(c: str) -> str:
    """The pattern's class of one character: "s" (whitespace), "L"
    (letter), "N" (number) or "o" (anything else)."""
    if c.isspace() and c not in _NOT_WHITE_SPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def split(text: str) -> Iterator[str]:
    """The pieces of GPT-2's pre-tokenization pattern, in order."""
    kinds = [_kind(c) for c in text]
    n, i = len(text), 0

    def run(j: int, kind: str) -> int:
        while j < n and kinds[j] == kind:
            j += 1
        return j

    while i < n:
        end = None
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                end = i + len(c)
                break
        if end is None:
            # " ?L+", " ?N+", " ?[^\s L N]+": an optional leading U+0020,
            # then a run of one class.
            j = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "s" else i
            if kinds[j] != "s":
                end = run(j, kinds[j])
            else:
                # "\s+(?!\S)", else "\s+": the whole run at the end of the
                # text, else all of it but its last character, unless that
                # leaves nothing.
                j = run(i, "s")
                end = j if j == n or j - 1 == i else j - 1
        yield text[i:end]
        i = end


def _byte_pair_merge(piece: bytes, ranks, max_rank: int) -> List[int]:
    """tiktoken-style BPE over one pre-tokenized piece: each round merges
    the adjacent pair whose concatenated bytes have the lowest rank (<
    ``max_rank``; the leftmost on a tie) until none is mergeable. Returns
    the token ids."""
    parts = list(range(len(piece) + 1))  # segment boundaries

    def pair_rank(i: int) -> int:
        r = ranks.get(piece[parts[i] : parts[i + 2]])
        return r if r is not None and r < max_rank else _NO_RANK

    while len(parts) > 2:
        best_i, best_r = -1, _NO_RANK
        for i in range(len(parts) - 2):
            r = pair_rank(i)
            if r < best_r:
                best_i, best_r = i, r
        if best_i < 0:
            break
        del parts[best_i + 1]

    out = []
    for a, b in zip(parts[:-1], parts[1:]):
        tid = ranks.get(piece[a:b])
        if tid is None:
            raise ValueError(
                f"byte sequence {piece[a:b]!r} has no token in this vocab — the "
                "vocab is not a complete byte-level BPE table"
            )
        out.append(tid)
    return out


def encode_text(vocab: Vocab, text: str) -> List[int]:
    """Encode ``text`` to token ids (no special tokens added). Only ids
    below EOT take part as merge ranks; a special's surface such as
    ``<|transcribe|>`` never matches, since the pre-tokenizer splits its
    punctuation apart."""
    ranks = vocab.token_to_id
    max_rank = vocab.specials.eot
    ids: List[int] = []
    for piece in split(text):
        raw = piece.encode("utf-8")
        whole = ranks.get(raw)
        if whole is not None and whole < max_rank:
            ids.append(whole)
        else:
            ids.extend(_byte_pair_merge(raw, ranks, max_rank))
    return ids


def encode_initial_prompt(vocab: Vocab, prompt: str) -> List[int]:
    """openai-whisper's ``initial_prompt`` tokenization: a leading space
    before the stripped text (``tokenizer.encode(" " +
    initial_prompt.strip())``). ``decode/prompt.build_prompt`` crops it to
    the last ``n_text_ctx // 2 - 1`` tokens."""
    return encode_text(vocab, " " + prompt.strip())
