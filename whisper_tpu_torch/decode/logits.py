"""Logit rules: suppression and timestamp constraints as additive masks.

Counterpart of ``whisper_tpu/decode/logits.py``. Every rule is an additive
mask on the [B, V] logits:

* static suppression: non-speech symbol tokens + the specials that must
  never be sampled (+ notimestamps when timestamps are on);
* blank suppression at the first sampled position (" " and EOT);
* timestamp grammar: timestamps come in pairs, never decrease, the first
  sampled token is a timestamp at most ``max_initial_timestamp_index``
  steps in, and a timestamp is forced when the total timestamp probability
  beats the best text token.

The position being sampled is either shared by all rows (a Python
``int``: the greedy and beam loops) or one per row (a ``[B]`` tensor: the
slot pool of ``decode/continuous.py``, where every slot decodes at its own
depth), as in the JAX version. The two forms give the same logits; the
per-row form replaces the position branches with ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_tpu_torch.tokenizer.vocab import Vocab

NEG_INF = -1e30

# Public Whisper non-speech symbol inventory.
_SYMBOLS = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    '<< >> <<< >>> -- --- -( -[ (\' (" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪'.split()
)
_MISC = set("♩♪♫♬♭♮♯")


def nonspeech_token_ids(vocab: Vocab) -> Tuple[int, ...]:
    """IDs whose surface is a standalone non-speech symbol (optionally
    space-prefixed), plus any token *starting* with a music symbol."""
    wanted = set()
    exact = set()
    for s in _SYMBOLS:
        exact.add(s.encode("utf-8"))
        exact.add((" " + s).encode("utf-8"))
    misc_prefixes = tuple(m.encode("utf-8") for m in _MISC)
    for tid in range(vocab.specials.eot):
        surf = vocab.id_to_token.get(tid)
        if surf is None:
            continue
        if surf in exact or surf in (b" -", b" '"):
            wanted.add(tid)
        elif misc_prefixes and surf.lstrip(b" ").startswith(misc_prefixes):
            wanted.add(tid)
    return tuple(sorted(wanted))


def blank_token_ids(vocab: Vocab) -> Tuple[int, ...]:
    ids = [tid for tid, s in vocab.id_to_token.items() if s == b" "]
    return tuple(ids)


@dataclasses.dataclass(frozen=True)
class LogitRules:
    """Precomputed rule tables; all tensor work happens in apply()."""

    n_vocab: int
    eot: int
    sot: int
    not_: int
    beg: int
    static_bias: np.ndarray  # [V] float32, NEG_INF at suppressed ids
    blank_bias: np.ndarray  # [V] extra bias at the first sampled position
    timestamps: bool = False
    max_initial_timestamp_index: int = 50

    def apply(
        self,
        logits: torch.Tensor,  # [B, V] float32
        tokens: torch.Tensor,  # [B, L] token buffer (read by timestamp rules)
        pos: Union[int, torch.Tensor],  # position being sampled: an int
        # shared by all rows, or [B] integers, one per row
        sample_begin: int,  # first sampled position
    ) -> torch.Tensor:
        logits = logits + self._bias("static_bias", logits.device)
        if isinstance(pos, torch.Tensor):
            is_first = (pos == sample_begin)[:, None]
            logits = logits + torch.where(is_first, self._bias("blank_bias", logits.device), 0.0)
        elif pos == sample_begin:
            logits = logits + self._bias("blank_bias", logits.device)
        if self.timestamps:
            logits = self._timestamp_rules(logits, tokens, pos, sample_begin)
        return logits

    # --- timestamp grammar --------------------------------------------------
    def _timestamp_rules(self, logits, tokens, pos, sample_begin: int):
        beg, eot = self.beg, self.eot
        ids = torch.arange(self.n_vocab, device=logits.device)[None, :]
        is_ts = ids >= beg
        is_text = ids < eot  # excludes eot and all specials/timestamps
        per_row = isinstance(pos, torch.Tensor)

        if per_row:
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            last = tokens[rows, torch.clamp_min(pos - 1, 0)]
            penult = tokens[rows, torch.clamp_min(pos - 2, 0)]
        else:
            last = tokens[:, max(pos - 1, 0)]
            penult = tokens[:, max(pos - 2, 0)]
        last_was_ts = (last >= beg) & (pos - 1 >= sample_begin)
        penult_was_ts = (penult >= beg) & (pos - 2 >= sample_begin)

        # Pairing: after  <ts> <ts>  → no timestamp; after text <ts> → no text.
        mask_ts = last_was_ts & penult_was_ts
        mask_text = last_was_ts & ~penult_was_ts
        bias = torch.where(mask_ts[:, None] & is_ts, NEG_INF, 0.0)
        bias = bias + torch.where(mask_text[:, None] & is_text, NEG_INF, 0.0)

        # Monotonicity: timestamps never decrease. Largest timestamp so far:
        cols = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        sampled_mask = (cols < (pos[:, None] if per_row else pos)) & (tokens >= beg)
        max_ts = torch.where(sampled_mask, tokens, beg - 1).amax(dim=1)  # [B]
        bias = bias + torch.where(
            is_ts & (ids < torch.clamp_min(max_ts, beg)[:, None]), NEG_INF, 0.0
        )

        # First sampled token must be a timestamp, capped at the initial max;
        # EOT stays legal there.
        if per_row or pos == sample_begin:
            first_bias = torch.where(~is_ts, NEG_INF, 0.0) + torch.where(
                ids > beg + self.max_initial_timestamp_index, NEG_INF, 0.0
            )
            first_bias = torch.where(ids == eot, 0.0, first_bias)
            if per_row:
                first_bias = torch.where((pos == sample_begin)[:, None], first_bias, 0.0)
            bias = bias + first_bias

        logits = logits + bias

        # Force a timestamp when total timestamp mass beats the best text
        # token (the openai "timestamp_logprob > max_text_token_logprob" rule).
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_mass = torch.logsumexp(torch.where(is_ts, logprobs, NEG_INF), dim=-1)
        best_text = torch.where(is_text, logprobs, NEG_INF).amax(dim=-1)
        force_ts = ts_mass > best_text
        return logits + torch.where(
            force_ts[:, None] & ~is_ts & (ids != eot), NEG_INF, 0.0
        )

    def _bias(self, name: str, device: torch.device) -> torch.Tensor:
        # One device copy per (table, device), built on first use.
        cache = self.__dict__.setdefault("_device_bias", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.from_numpy(getattr(self, name)).to(device)
        return cache[key]


def make_rules(
    vocab: Vocab,
    timestamps: bool = False,
    suppress_blank: bool = True,
    suppress_nonspeech: bool = True,
    extra_suppress: Sequence[int] = (),
    max_initial_timestamp_index: int = 50,
    n_vocab: Optional[int] = None,
) -> LogitRules:
    st = vocab.specials
    v = n_vocab or max(vocab.id_to_token.keys()) + 1

    static = np.zeros((v,), dtype=np.float32)
    suppressed = set(extra_suppress)
    # Specials that must never be sampled mid-transcript — openai
    # decoding.py's _get_suppress_tokens.
    suppressed |= {
        st.sot, st.prev, st.solm, st.transcribe, st.translate, st.nospeech,
    }
    if suppress_nonspeech:
        suppressed |= set(nonspeech_token_ids(vocab))
    if timestamps:
        suppressed.add(st.not_)
    for tid in suppressed:
        if tid < v:
            static[tid] = NEG_INF

    blank = np.zeros((v,), dtype=np.float32)
    if suppress_blank:
        for tid in blank_token_ids(vocab):
            if tid < v:
                blank[tid] = NEG_INF
        blank[st.eot] = NEG_INF

    return LogitRules(
        n_vocab=v,
        eot=st.eot,
        sot=st.sot,
        not_=st.not_,
        beg=st.beg,
        static_bias=static,
        blank_bias=blank,
        timestamps=timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index,
    )
