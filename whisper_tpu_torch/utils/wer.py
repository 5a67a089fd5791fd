"""Word-error-rate evaluation.

Counterpart of ``whisper_tpu/utils/wer.py`` (the port keeps its own copy):
word-level Levenshtein distance after the usual English normalization of
Whisper evaluations (lowercase, punctuation dropped with apostrophes kept,
whitespace collapsed).
"""

from __future__ import annotations

import dataclasses
import re
import string
from typing import Iterable, List, Sequence, Tuple

_PUNCT = str.maketrans("", "", string.punctuation.replace("'", ""))


def normalize_text(text: str) -> str:
    """Basic English normalization: lowercase, drop punctuation (apostrophes
    kept — contractions are words), collapse whitespace."""
    text = text.lower().translate(_PUNCT)
    return re.sub(r"\s+", " ", text).strip()


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int, int]:
    """Word-level Levenshtein alignment.

    Returns (substitutions, deletions, insertions, hits) for the minimal-cost
    alignment (two-row DP with backtrack-free op counting via parallel count
    tables — O(len(ref)·len(hyp)) time, O(len(hyp)) space).
    """
    n, m = len(ref), len(hyp)
    # rows of (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [(0, 0, 0, 0)] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, s, d, ins = prev[j - 1]
                cur[j] = (c, s, d, ins)
                continue
            sub_c, sub_s, sub_d, sub_i = prev[j - 1]
            del_c, del_s, del_d, del_i = prev[j]
            ins_c, ins_s, ins_d, ins_i = cur[j - 1]
            best = min(sub_c, del_c, ins_c)
            if best == sub_c:
                cur[j] = (sub_c + 1, sub_s + 1, sub_d, sub_i)
            elif best == del_c:
                cur[j] = (del_c + 1, del_s, del_d + 1, del_i)
            else:
                cur[j] = (ins_c + 1, ins_s, ins_d, ins_i + 1)
        prev = cur
    cost, subs, dels, ins = prev[m]
    hits = n - subs - dels
    return subs, dels, ins, hits


@dataclasses.dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    hits: int
    ref_words: int

    def as_dict(self):
        return dataclasses.asdict(self)


def word_error_rate(
    references: Iterable[str],
    hypotheses: Iterable[str],
    normalize: bool = True,
) -> WerResult:
    """Corpus WER: total edits / total reference words."""
    refs: List[str] = list(references)
    hyps: List[str] = list(hypotheses)
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} hypotheses")
    S = D = I = H = N = 0
    for r, h in zip(refs, hyps):
        if normalize:
            r, h = normalize_text(r), normalize_text(h)
        rw, hw = r.split(), h.split()
        s, d, i, hits = edit_distance(rw, hw)
        S, D, I, H, N = S + s, D + d, I + i, H + hits, N + len(rw)
    wer = (S + D + I) / N if N else 0.0
    return WerResult(wer, S, D, I, H, N)
