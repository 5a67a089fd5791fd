"""Vocabulary + special-token model.

Reproduces the reference's ``Vocab`` (whisper.h:44-94): the English-model
special-token IDs, the multilingual "+1 shift" transform
(``transform_vocab_multilingual``, whisper.cpp:218-226), and the synthesis of
surface forms for special tokens missing from a vocab file
(``Reader::read_vocab``, whisper.cpp:578-604).

Token-ID arithmetic here is a hard numeric contract (SURVEY.md §2a.8):
the decoder prompt is ``[sot, sot+1+language_id(lang), task, notimestamps]``
and the task tokens are *not* shifted by the multilingual transform.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from whisper_tpu_torch.config import N_VOCAB_ENGLISH
from whisper_tpu_torch.tokenizer.languages import LANGUAGES, lang_code


@dataclasses.dataclass
class SpecialTokens:
    """Special-token IDs, derived from the actual tokenizer layout:

        eot, sot, <languages ×N>, translate, transcribe, startoflm,
        startofprev, nospeech, notimestamps, <timestamps…>

    The reference instead hardcodes an English table and a "+1 shift"
    multilingual transform (whisper.h:34-42, whisper.cpp:218-226) which is
    WRONG about the task tokens: the real multilingual vocab has
    translate=50358/transcribe=50359, and the reference's own decoder prompt
    hardcodes the (correct) 50359 rather than its shifted table value
    (whisper.cpp:331-339). large-v3 adds a 100th language (<|yue|>), pushing
    every token after the language block up by one (n_vocab 51866) — the
    derived form below covers all three layouts; the constructor is
    :func:`special_tokens_for`.
    """

    eot: int
    sot: int
    translate: int
    transcribe: int
    solm: int  # <|startoflm|>
    prev: int  # <|startofprev|>
    nospeech: int  # <|nospeech|>
    not_: int  # <|notimestamps|>
    beg: int  # first timestamp token <|0.00|>
    num_languages: int

    def lang_token(self, language_id: int) -> int:
        """Language token = sot + 1 + index in the language table
        (reference: ``50259 + language_id`` with sot=50258,
        whisper.cpp:326-329)."""
        if language_id >= self.num_languages:
            raise ValueError(
                f"language id {language_id} outside this model's "
                f"{self.num_languages}-language table (yue needs large-v3)"
            )
        return self.sot + 1 + language_id


def special_tokens_for(
    multilingual: bool, num_languages: int = 99
) -> SpecialTokens:
    """Token table for (multilingual?, #languages). Verified layouts:

    * English .en (99 langs):  eot 50256, sot 50257, translate 50357,
      transcribe 50358, solm 50359, prev 50360, nospeech 50361,
      notimestamps 50362, beg 50363 — n_vocab 51864
    * multilingual (99):       eot 50257, sot 50258, translate 50358,
      transcribe 50359, …, notimestamps 50363, beg 50364 — n_vocab 51865
    * large-v3 (100, +<|yue|>): translate 50359, transcribe 50360, …,
      notimestamps 50364, beg 50365 — n_vocab 51866
    """
    eot = 50257 if multilingual else 50256
    sot = eot + 1
    translate = sot + 1 + num_languages
    return SpecialTokens(
        eot=eot,
        sot=sot,
        translate=translate,
        transcribe=translate + 1,
        solm=translate + 2,
        prev=translate + 3,
        nospeech=translate + 4,
        not_=translate + 5,
        beg=translate + 6,
        num_languages=num_languages,
    )


def num_languages_for(n_vocab: int) -> int:
    """Language-table size implied by the vocab size: large-v3's 51866
    carries the 100th (<|yue|>) language token."""
    return 100 if n_vocab >= 51_866 else 99


class Vocab:
    """ID ↔ surface-byte-string table plus special IDs.

    Surfaces are ``bytes``: Whisper's BPE merges operate on a unicode
    remapping, but stored vocab surfaces (both in the reference's ``.bin``
    and after our HF conversion) are the raw decoded bytes, concatenated
    directly by the detokenizer (reference decode(), whisper.cpp:640-654).
    """

    def __init__(
        self,
        id_to_token: Dict[int, bytes],
        multilingual: bool,
        n_vocab: Optional[int] = None,
        num_languages: Optional[int] = None,
    ):
        self.multilingual = multilingual
        self.n_vocab = (
            n_vocab if n_vocab is not None else N_VOCAB_ENGLISH + int(multilingual)
        )
        if num_languages is None:
            num_languages = num_languages_for(self.n_vocab)
        self.specials = special_tokens_for(multilingual, num_languages)
        self.id_to_token: Dict[int, bytes] = dict(id_to_token)
        self._fill_missing_specials()
        self.token_to_id: Dict[bytes, int] = {
            tok: i for i, tok in self.id_to_token.items()
        }

    # Surface synthesis for special IDs absent from the file, mirroring the
    # reference's fallback strings (whisper.cpp:578-604). These exact strings
    # only appear in output when omit_special_tokens=False, matching the
    # reference byte-for-byte there too.
    def _fill_missing_specials(self) -> None:
        st = self.specials
        # 1501 timestamp tokens <|0.00|>..<|30.00|> follow beg: yields 51864
        # (.en) / 51865 (multilingual) / 51866 (large-v3) — SURVEY.md §2a.
        expected = st.beg + 1501
        total = max(self.n_vocab, expected)
        for i in range(total):
            if i in self.id_to_token:
                continue
            if i > st.beg:
                word = f"<|TT{i - st.beg}|>"
            elif i == st.eot:
                word = "<|endoftranscript|>"
            elif i == st.sot:
                word = "<|startoftranscript_|>"
            elif i == st.prev:
                word = "<|PREV|>"
            elif i == st.not_:
                word = "<|notimestamps|>"
            elif i == st.beg:
                word = "<|timestampbegin|>"
            elif i == st.translate:
                word = "<|translate|>"
            elif i == st.transcribe:
                word = "<|transcribe|>"
            elif i == st.solm:
                word = "<|startoflm|>"
            elif i == st.nospeech:
                word = "<|nospeech|>"
            elif st.sot < i < st.translate:
                lid = i - (st.sot + 1)
                if lid < len(LANGUAGES):
                    word = f"<|lang-{lang_code(lid)}|>"
                else:
                    word = f"<|e{i}|>"
            else:
                word = f"<|e{i}|>"
            self.id_to_token[i] = word.encode("utf-8")

    # --- lookups -----------------------------------------------------------
    def surface(self, token_id: int) -> bytes:
        return self.id_to_token[token_id]

    def is_special(self, token_id: int) -> bool:
        """Reference policy: "special" means ``id >= token_eot``
        (decode() guard ``id < vocab.token_eot``, whisper.cpp:648)."""
        return token_id >= self.specials.eot

    # --- constructors ------------------------------------------------------
    @classmethod
    def synthetic(
        cls,
        multilingual: bool = False,
        n_base: int = 256,
        num_languages: Optional[int] = None,
    ) -> "Vocab":
        """Small deterministic vocab for tests: base tokens are single bytes,
        specials synthesized. Not a real BPE vocab. ``num_languages=100``
        selects the large-v3 token layout."""
        table = {i: bytes([i]) for i in range(n_base)}
        return cls(
            table, multilingual=multilingual, n_vocab=n_base,
            num_languages=num_languages,
        )

    @classmethod
    def from_hf_tokenizer(cls, tokenizer, multilingual: bool) -> "Vocab":
        """Build from a HuggingFace WhisperTokenizer (byte-level BPE).

        Converts the tokenizer's unicode-remapped vocab strings back to raw
        bytes. Replaces the reference's offline vocab-bin pipeline
        (export + app/writeout.cpp) for environments with HF assets.
        """
        byte_decoder = _bytes_to_unicode_inverse()
        table: Dict[int, bytes] = {}
        for tok_str, idx in tokenizer.get_vocab().items():
            if tok_str.startswith("<|") and tok_str.endswith("|>"):
                table[idx] = tok_str.encode("utf-8")
            else:
                try:
                    table[idx] = bytes(byte_decoder[c] for c in tok_str)
                except KeyError:
                    table[idx] = tok_str.encode("utf-8")
        return cls(table, multilingual=multilingual, n_vocab=len(table))


def _bytes_to_unicode_inverse() -> Dict[str, int]:
    """Inverse of GPT-2's bytes↔unicode remapping (public BPE convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}
