from whisper_tpu_torch.decode.greedy import argmax_last, greedy_decode
from whisper_tpu_torch.decode.prompt import build_prompt

__all__ = ["greedy_decode", "argmax_last", "build_prompt"]
