from whisper_tpu_torch.models.decoder import (
    decoder_prefill,
    decoder_step,
    decoder_window,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.models.encoder import encode
from whisper_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    sinusoid_position_embedding,
)

__all__ = [
    "init_params",
    "params_from_jax",
    "sinusoid_position_embedding",
    "encode",
    "init_kv_cache",
    "precompute_cross_kv",
    "decoder_prefill",
    "decoder_step",
    "decoder_window",
]
