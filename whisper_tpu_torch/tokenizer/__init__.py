from whisper_tpu_torch.tokenizer.detokenize import decode_tokens, remove_extra_spaces
from whisper_tpu_torch.tokenizer.languages import LANGUAGES, lang_code, language_id
from whisper_tpu_torch.tokenizer.vocab import SpecialTokens, Vocab

__all__ = [
    "Vocab",
    "SpecialTokens",
    "LANGUAGES",
    "language_id",
    "lang_code",
    "decode_tokens",
    "remove_extra_spaces",
]
