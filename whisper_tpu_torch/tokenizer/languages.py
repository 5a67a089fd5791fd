"""Whisper language table.

Same 100 ``(code, name)`` pairs, in canonical Whisper order, as the reference
table (whisper.cpp:405-508) — this order is load-bearing: the decoder's
language token is ``sot + 1 + language_id(code)`` (reference computes it as
``50259 + language_id``, whisper.cpp:326-329, with multilingual sot=50258).
The list itself is the public openai-whisper language registry.
"""

from __future__ import annotations

LANGUAGES: tuple[tuple[str, str], ...] = (
    ("en", "english"), ("zh", "chinese"), ("de", "german"), ("es", "spanish"),
    ("ru", "russian"), ("ko", "korean"), ("fr", "french"), ("ja", "japanese"),
    ("pt", "portuguese"), ("tr", "turkish"), ("pl", "polish"), ("ca", "catalan"),
    ("nl", "dutch"), ("ar", "arabic"), ("sv", "swedish"), ("it", "italian"),
    ("id", "indonesian"), ("hi", "hindi"), ("fi", "finnish"), ("vi", "vietnamese"),
    ("he", "hebrew"), ("uk", "ukrainian"), ("el", "greek"), ("ms", "malay"),
    ("cs", "czech"), ("ro", "romanian"), ("da", "danish"), ("hu", "hungarian"),
    ("ta", "tamil"), ("no", "norwegian"), ("th", "thai"), ("ur", "urdu"),
    ("hr", "croatian"), ("bg", "bulgarian"), ("lt", "lithuanian"), ("la", "latin"),
    ("mi", "maori"), ("ml", "malayalam"), ("cy", "welsh"), ("sk", "slovak"),
    ("te", "telugu"), ("fa", "persian"), ("lv", "latvian"), ("bn", "bengali"),
    ("sr", "serbian"), ("az", "azerbaijani"), ("sl", "slovenian"), ("kn", "kannada"),
    ("et", "estonian"), ("mk", "macedonian"), ("br", "breton"), ("eu", "basque"),
    ("is", "icelandic"), ("hy", "armenian"), ("ne", "nepali"), ("mn", "mongolian"),
    ("bs", "bosnian"), ("kk", "kazakh"), ("sq", "albanian"), ("sw", "swahili"),
    ("gl", "galician"), ("mr", "marathi"), ("pa", "punjabi"), ("si", "sinhala"),
    ("km", "khmer"), ("sn", "shona"), ("yo", "yoruba"), ("so", "somali"),
    ("af", "afrikaans"), ("oc", "occitan"), ("ka", "georgian"), ("be", "belarusian"),
    ("tg", "tajik"), ("sd", "sindhi"), ("gu", "gujarati"), ("am", "amharic"),
    ("yi", "yiddish"), ("lo", "lao"), ("uz", "uzbek"), ("fo", "faroese"),
    ("ht", "haitian creole"), ("ps", "pashto"), ("tk", "turkmen"), ("nn", "nynorsk"),
    ("mt", "maltese"), ("sa", "sanskrit"), ("lb", "luxembourgish"), ("my", "myanmar"),
    ("bo", "tibetan"), ("tl", "tagalog"), ("mg", "malagasy"), ("as", "assamese"),
    ("tt", "tatar"), ("haw", "hawaiian"), ("ln", "lingala"), ("ha", "hausa"),
    ("ba", "bashkir"), ("jw", "javanese"), ("su", "sundanese"), ("yue", "cantonese"),
)

_CODE_TO_ID = {code: i for i, (code, _name) in enumerate(LANGUAGES)}
_NAME_TO_ID = {name: i for i, (_code, name) in enumerate(LANGUAGES)}


def language_id(code: str) -> int:
    """Index of ``code`` in the table.

    The reference's linear search returns ``len(table)`` for unknown codes
    (std::find_if end iterator, whisper.cpp:510-515); we raise instead —
    a silent out-of-range language token is never what you want.
    """
    try:
        return _CODE_TO_ID[code]
    except KeyError:
        try:
            return _NAME_TO_ID[code.lower()]
        except KeyError:
            raise KeyError(f"unknown language: {code!r}") from None


def lang_code(lid: int) -> str:
    """Inverse of :func:`language_id` (reference whisper.cpp:517)."""
    return LANGUAGES[lid][0]


def lang_name(lid: int) -> str:
    return LANGUAGES[lid][1]
