"""Sequential long-form transcription: openai's seek loop.

The port's own copy of ``whisper_tpu/decode/sequential.py``. openai-whisper's
``transcribe()`` walks a file of any length with a sliding 30 s window:
decode a window with timestamps, advance ``seek`` to the end of the last
*complete* segment (or the whole window when the decode ran off its end),
and condition the next window on the transcript so far
(``condition_on_previous_text``). The loop itself is
``engine.Engine.transcribe_sequential``; this module holds its host-side
bookkeeping.

The conditioning prefix is cropped to a fixed menu of lengths
(:data:`PREFIX_LENS`), as in JAX. There the menu bounds the number of
compiled programs; the eager port compiles nothing per length, but keeps
the crop because it decides which tokens condition the next window.

Window advance (openai transcribe.py ``timestamp`` handling):

* consecutive timestamp pair(s) in the decode → the segments up to the last
  pair are final; seek advances to that pair's FIRST timestamp (the end of
  the last complete segment). The unfinished tail re-decodes in the next
  window.
* no consecutive pair, or one closing timestamp at the end → every segment
  of the window is final; seek advances the whole window.
* a minimum advance guards against a loop that does not move.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# Prefix-length menu (tokens): the base prompt + 1 (<|startofprev|>) + one
# of these; 222 ≈ openai's n_text_ctx // 2 - 1 crop.
PREFIX_LENS = (31, 63, 95, 127, 159, 191, 222)
MIN_ADVANCE_SECONDS = 1.0
WINDOW_SECONDS = 30.0
TIME_PER_TOKEN = 0.02


def choose_prefix_len(n_prev: int) -> int:
    """Crop length for ``n_prev`` available conditioning tokens: the largest
    menu entry that fits within them (the most recent tokens are kept),
    capped at 222. 0 until the smallest entry's worth of context exists:
    conditioning starts a window or two later rather than padding the
    prompt with repeated tokens (a known repetition trigger)."""
    if n_prev <= 0:
        return 0
    best = 0
    for cand in PREFIX_LENS:
        if cand <= n_prev:
            best = cand
    return best


def crop_prefix(prev_tokens: Sequence[int]) -> List[int]:
    """The conditioning prefix passed to the next window: the last
    ``choose_prefix_len`` tokens — real transcript tokens only; empty until
    enough context has accumulated."""
    keep = choose_prefix_len(len(prev_tokens))
    if keep == 0:
        return []
    return [int(t) for t in prev_tokens[-keep:]]


def window_emit_and_advance(
    gen_tokens: Sequence[int],
    beg: int,
    eot: int,
    window_seconds: float = WINDOW_SECONDS,
) -> Tuple[List[int], float]:
    """Split one window's GENERATED tokens (prompt excluded) into the tokens
    whose segments are final this window, and the seek advance in seconds
    (the consecutive-timestamp rule of the module docstring)."""
    toks: List[int] = []
    for t in gen_tokens:
        if t == eot:
            break
        toks.append(int(t))

    is_ts = [t >= beg for t in toks]
    last_pair_second = None  # index of the 2nd token of the last ts pair
    for i in range(len(toks) - 1):
        if is_ts[i] and is_ts[i + 1]:
            last_pair_second = i + 1
    # openai's single_timestamp_ending: the decode ended with one timestamp
    # closing the final segment, so everything is final and the whole
    # window advances.
    single_ts_ending = len(toks) >= 2 and (not is_ts[-2]) and is_ts[-1]
    if last_pair_second is not None and not single_ts_ending:
        advance = (toks[last_pair_second - 1] - beg) * TIME_PER_TOKEN
        # Keep through the closing timestamp; the pair's second timestamp
        # opens the next segment, which re-decodes in the next window.
        emit = toks[:last_pair_second]
        return emit, max(advance, MIN_ADVANCE_SECONDS)
    return toks, window_seconds
