"""Detokenizer: token IDs → text.

Behavior contract (reference ``decode()`` whisper.cpp:634-665 and
``remove_extra_spaces`` whisper.cpp:613-631):

* concatenate surface byte strings in order;
* with ``omit_special_tokens``, skip any id >= eot (whisper.cpp:648);
* the EOT token terminates decoding — *after* its surface was appended when
  specials are not omitted (the reference appends, then breaks,
  whisper.cpp:645-656);
* ``remove_extra_spaces`` collapses runs of ASCII spaces to one.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from whisper_tpu_torch.tokenizer.vocab import Vocab


def decode_tokens(
    vocab: Vocab,
    token_ids: Sequence[int],
    omit_special_tokens: bool = False,
    errors: str = "replace",
) -> str:
    eot = vocab.specials.eot
    out = bytearray()
    for tid in token_ids:
        tid = int(tid)
        if (not omit_special_tokens) or tid < eot:
            out += vocab.surface(tid)
        if tid == eot:
            break
    return out.decode("utf-8", errors=errors)


def remove_extra_spaces(text: str) -> str:
    out = []
    prev_space = False
    for ch in text:
        if ch == " ":
            if not prev_space:
                out.append(ch)
            prev_space = True
        else:
            out.append(ch)
            prev_space = False
    return "".join(out)
