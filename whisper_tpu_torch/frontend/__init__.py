from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram, pad_or_trim

__all__ = ["mel_filterbank", "log_mel_spectrogram", "pad_or_trim"]
