"""Decoder prompt construction.

Contract (SURVEY.md §2a.8, reference whisper.cpp:327-339):

* multilingual: ``[sot, sot+1+language_id(lang), task, notimestamps]`` — the
  reference hardcodes ``"de"`` and expects ``[50258, 50261, 50359, 50363]``;
* English-only models: ``[sot, notimestamps]`` (the golden tiny.en output
  starts ``50257, 50362`` — whisper.h:27-32).

With the corrected token table (tokenizer/vocab.py special_tokens_for) the
default transcribe prompt for 99-language multilingual models IS the
reference's literal sequence — its hardcoded IDs were checkpoint-correct
even though its own "+1 shift" vocab table wasn't. ``reference_quirks=True``
pins the literal IDs 50359/50363 regardless of model: it diverges from the
default only for the translate task, timestamp mode, and large-v3's
100-language layout (where the real task/notimestamps IDs are 50360/50364).
"""

from __future__ import annotations

from typing import List, Optional

from whisper_tpu_torch.tokenizer.languages import language_id
from whisper_tpu_torch.tokenizer.vocab import SpecialTokens, special_tokens_for


def build_prompt(
    multilingual: bool,
    language: Optional[str] = None,
    task: str = "transcribe",
    timestamps: bool = False,
    specials: Optional[SpecialTokens] = None,
    reference_quirks: bool = False,
    prefix_tokens: Optional[List[int]] = None,
    n_text_ctx: int = 448,
) -> List[int]:
    """``prefix_tokens`` prepends conditioning context before the SOT
    sequence as ``[<|startofprev|>] + prefix`` — openai-whisper's
    ``initial_prompt`` / previous-text conditioning (decoding.py
    ``_get_initial_tokens``). The prefix is cropped to the LAST
    ``n_text_ctx // 2 - 1`` tokens, exactly openai's window. The reference
    has no conditioning concept at all (whisper.cpp:327-339)."""
    st = specials or special_tokens_for(multilingual)
    if not multilingual:
        prompt = [st.sot]
        if not timestamps:
            prompt.append(st.not_)
    elif reference_quirks:
        # Literal reference sequence (whisper.cpp:331-339).
        lang = language or "en"
        prompt = [st.sot, st.lang_token(language_id(lang)), 50359]
        if not timestamps:
            prompt.append(50363)
    else:
        lang = language or "en"
        task_token = st.transcribe if task == "transcribe" else st.translate
        prompt = [st.sot, st.lang_token(language_id(lang)), task_token]
        if not timestamps:
            prompt.append(st.not_)
    if prefix_tokens:
        keep = max(n_text_ctx // 2 - 1, 0)
        prompt = [st.prev] + [int(t) for t in prefix_tokens][-keep:] + prompt
    return prompt
