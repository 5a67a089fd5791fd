from whisper_tpu_torch.audio.wav import read_pcm_f32, read_wav, read_wav_legacy, write_wav

__all__ = ["read_wav", "read_wav_legacy", "write_wav", "read_pcm_f32"]
