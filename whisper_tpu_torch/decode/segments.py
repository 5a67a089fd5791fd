"""Timestamped segment extraction from decoded token streams (copy of
``whisper_tpu/decode/segments.py``).

With ``timestamps=True`` the decoder emits Whisper's timestamp grammar
(``<|0.00|>`` … pairs bracketing text — enforced during decoding by
decode/logits.py's timestamp rules). This module is the host-side parser
turning a token row into ``Segment(start, end, text)`` triples. Timestamp
token *t* means ``(t - beg) * 0.02`` seconds into the 30 s window (20 ms
frames — 1500 timestamp positions cover exactly the n_audio_ctx grid).

The reference has no equivalent — it always sends ``<|notimestamps|>``
(whisper.cpp:339) and returns one flat string.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from whisper_tpu_torch.tokenizer.detokenize import decode_tokens
from whisper_tpu_torch.tokenizer.vocab import Vocab

TIME_PER_TOKEN = 0.02  # seconds per timestamp step


@dataclasses.dataclass(frozen=True)
class Segment:
    start: float  # seconds from window start
    end: float
    text: str
    tokens: tuple  # text token ids (specials excluded)


def parse_segments(
    vocab: Vocab,
    tokens: Sequence[int],
    time_offset: float = 0.0,
) -> List[Segment]:
    """Token row (prompt included) → list of timestamped segments.

    Grammar handled: ``<|t0|> text… <|t1|> <|t2|> text… <|t3|> … eot``.
    A lone trailing timestamp (no closing pair before EOT) closes its
    segment at the final timestamp seen or the window end. Rows decoded
    with ``<|notimestamps|>`` yield one segment spanning the window.
    """
    st = vocab.specials
    beg, eot = st.beg, st.eot
    toks = [int(t) for t in tokens]

    # Strip prompt specials / stop at EOT; keep order.
    body: List[int] = []
    for t in toks:
        if t == eot:
            break
        body.append(t)

    has_ts = any(t >= beg for t in body)
    if not has_ts:
        text_ids = [t for t in body if t < eot]
        text = decode_tokens(vocab, np.asarray(text_ids + [eot]), True)
        return [
            Segment(time_offset, time_offset + 30.0, text, tuple(text_ids))
        ] if text_ids else []

    segments: List[Segment] = []
    start_t: float | None = None
    cur: List[int] = []
    for t in body:
        if t >= beg:
            ts = (t - beg) * TIME_PER_TOKEN
            if start_t is None:
                start_t = ts
            elif cur:
                segments.append(
                    Segment(
                        time_offset + start_t,
                        time_offset + ts,
                        decode_tokens(vocab, np.asarray(cur + [eot]), True),
                        tuple(cur),
                    )
                )
                cur, start_t = [], ts
            else:
                start_t = ts  # consecutive timestamps: segment boundary
        elif t < eot and start_t is not None:
            cur.append(t)
    if cur and start_t is not None:
        segments.append(
            Segment(
                time_offset + start_t,
                time_offset + 30.0,
                decode_tokens(vocab, np.asarray(cur + [eot]), True),
                tuple(cur),
            )
        )
    return segments
