from whisper_tpu_torch.audio.vad import energy_vad, frame_energies, remove_silence, speech_segments
from whisper_tpu_torch.audio.wav import read_pcm_f32, read_wav, read_wav_legacy, write_wav

__all__ = [
    "read_wav",
    "read_wav_legacy",
    "write_wav",
    "read_pcm_f32",
    "frame_energies",
    "energy_vad",
    "remove_silence",
    "speech_segments",
]
