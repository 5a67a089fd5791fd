"""Spoken-language identification from the decoder's SOT-position logits.

Counterpart of ``whisper_tpu/decode/language.py``: feed ``[sot]`` against
the cross-attention K/V, restrict the next-token logits to the
language-token block ``[sot+1, sot+1+n_langs)``, and take the argmax. Ties
go to the LOWEST index (``jnp.argmax`` and ``torch.argmax`` agree), unlike
the greedy pick, which takes the highest.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_tpu_torch.config import N_VOCAB_LARGE_V3, ModelDims
from whisper_tpu_torch.models.decoder import (
    KVCache,
    decoder_prefill,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.models.params import Params
from whisper_tpu_torch.parallel import collectives
from whisper_tpu_torch.tokenizer.languages import lang_code


def n_langs_for(dims: ModelDims) -> int:
    return 100 if dims.n_vocab >= N_VOCAB_LARGE_V3 else 99


@collectives.stage("detect")
def detect_language_tokens(
    params: Params,
    enc_out: torch.Tensor,  # [B, n_audio_ctx, d]
    dims: ModelDims,
    sot: int,
    compute_dtype: torch.dtype = torch.float32,
    cross_kv: Optional[KVCache] = None,
    return_probs: bool = False,
    tp=None,
) -> torch.Tensor | Tuple[torch.Tensor, torch.Tensor]:
    """Returns language token ids [B] (and, optionally, the softmax
    distribution over the language block [B, n_langs]). ``tp``: this
    rank's mesh; every rank of its model group gets the same logits."""
    b = enc_out.shape[0]
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, enc_out, dims, tp=tp)
    cache = init_kv_cache(dims, b, 1, dtype=compute_dtype, device=enc_out.device, tp=tp)
    prompt = torch.full((b, 1), sot, dtype=torch.long, device=enc_out.device)
    logits, _ = decoder_prefill(params, prompt, cache, cross_kv, dims, compute_dtype, tp=tp)
    lang_base = sot + 1
    block = logits[:, 0, lang_base : lang_base + n_langs_for(dims)]
    tokens = lang_base + torch.argmax(block, dim=-1)
    if return_probs:
        return tokens, torch.softmax(block, dim=-1)
    return tokens


def lang_token_to_code(token: int, sot: int) -> str:
    """Host-side: language token id → ISO code ("" if out of range)."""
    lid = int(token) - sot - 1
    if 0 <= lid < 100:
        return lang_code(lid)
    return ""
