"""Checkpoint conversion: HF and openai-whisper weights → port parameters.

Counterpart of ``whisper_tpu/models/convert.py``. Two source dialects:

* HuggingFace ``WhisperForConditionalGeneration`` state dicts
  (``model.encoder.layers.N.self_attn.q_proj.weight`` …);
* openai-whisper ``.pt`` checkpoints (``encoder.blocks.N.attn.query.weight``
  …, with a ``dims`` header).

The port's parameters are returned directly: torch ``Linear`` weights
``[out, in]`` transpose to the port's ``[in, out]``, conv weights keep
torch's ``[c_out, c_in, width]``, and each transformer block is one dict
of the ``blocks`` list (JAX stacks them for ``lax.scan``; the port needs
no stacking). Values and dtypes are the source's.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import ModelDims
from whisper_tpu_torch.models.params import Params


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return torch.from_numpy(np.array(x))


def _linear(sd: Mapping, prefix: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    p = {"w": _t(sd[f"{prefix}.weight"]).t().contiguous()}
    key = f"{prefix}.bias"
    if bias and key in sd and sd[key] is not None:
        p["b"] = _t(sd[key])
    return p


def _ln(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {"g": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {"w": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


# --- HuggingFace dialect ---------------------------------------------------
def dims_from_hf_config(cfg) -> ModelDims:
    return ModelDims(
        n_mels=cfg.num_mel_bins,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_vocab=cfg.vocab_size,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
    )


def from_hf_state_dict(sd: Mapping[str, Any], dims: ModelDims) -> Params:
    def attn(prefix: str) -> Dict:
        return {
            "q": _linear(sd, f"{prefix}.q_proj"),
            "k": _linear(sd, f"{prefix}.k_proj", bias=False),
            "v": _linear(sd, f"{prefix}.v_proj"),
            "o": _linear(sd, f"{prefix}.out_proj"),
        }

    def mlp(pre: str) -> Dict:
        return {"fc1": _linear(sd, f"{pre}.fc1"), "fc2": _linear(sd, f"{pre}.fc2")}

    enc_blocks = [
        {
            "ln1": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "attn": attn(f"{pre}.self_attn"),
            "ln2": _ln(sd, f"{pre}.final_layer_norm"),
            "mlp": mlp(pre),
        }
        for pre in (f"model.encoder.layers.{i}" for i in range(dims.n_audio_layer))
    ]
    dec_blocks = [
        {
            "ln1": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "attn": attn(f"{pre}.self_attn"),
            "ln2": _ln(sd, f"{pre}.encoder_attn_layer_norm"),
            "cross": attn(f"{pre}.encoder_attn"),
            "ln3": _ln(sd, f"{pre}.final_layer_norm"),
            "mlp": mlp(pre),
        }
        for pre in (f"model.decoder.layers.{i}" for i in range(dims.n_text_layer))
    ]
    return {
        "encoder": {
            "conv1": _conv(sd, "model.encoder.conv1"),
            "conv2": _conv(sd, "model.encoder.conv2"),
            "blocks": enc_blocks,
            "ln_post": _ln(sd, "model.encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": _t(sd["model.decoder.embed_tokens.weight"]),
            "pos_emb": _t(sd["model.decoder.embed_positions.weight"]),
            "blocks": dec_blocks,
            "ln": _ln(sd, "model.decoder.layer_norm"),
        },
    }


# --- openai-whisper dialect ------------------------------------------------
def dims_from_openai(dims_dict: Mapping[str, int]) -> ModelDims:
    return ModelDims(
        n_mels=dims_dict["n_mels"],
        n_audio_ctx=dims_dict["n_audio_ctx"],
        n_audio_state=dims_dict["n_audio_state"],
        n_audio_head=dims_dict["n_audio_head"],
        n_audio_layer=dims_dict["n_audio_layer"],
        n_vocab=dims_dict["n_vocab"],
        n_text_ctx=dims_dict["n_text_ctx"],
        n_text_state=dims_dict["n_text_state"],
        n_text_head=dims_dict["n_text_head"],
        n_text_layer=dims_dict["n_text_layer"],
    )


def from_openai_state_dict(sd: Mapping[str, Any], dims: ModelDims) -> Params:
    def attn(prefix: str) -> Dict:
        return {
            "q": _linear(sd, f"{prefix}.query"),
            "k": _linear(sd, f"{prefix}.key", bias=False),
            "v": _linear(sd, f"{prefix}.value"),
            "o": _linear(sd, f"{prefix}.out"),
        }

    def block(pre: str, cross: bool) -> Dict:
        d = {"ln1": _ln(sd, f"{pre}.attn_ln"), "attn": attn(f"{pre}.attn")}
        if cross:
            d["ln2"] = _ln(sd, f"{pre}.cross_attn_ln")
            d["cross"] = attn(f"{pre}.cross_attn")
            d["ln3"] = _ln(sd, f"{pre}.mlp_ln")
        else:
            d["ln2"] = _ln(sd, f"{pre}.mlp_ln")
        d["mlp"] = {"fc1": _linear(sd, f"{pre}.mlp.0"), "fc2": _linear(sd, f"{pre}.mlp.2")}
        return d

    return {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "blocks": [block(f"encoder.blocks.{i}", False) for i in range(dims.n_audio_layer)],
            "ln_post": _ln(sd, "encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": _t(sd["decoder.token_embedding.weight"]),
            "pos_emb": _t(sd["decoder.positional_embedding"]),
            "blocks": [block(f"decoder.blocks.{i}", True) for i in range(dims.n_text_layer)],
            "ln": _ln(sd, "decoder.ln"),
        },
    }


def openai_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`from_openai_state_dict` for float parameters:
    an openai-whisper state dict, which ``torch.save({"dims": ...,
    "model_state_dict": ...})`` writes as a ``.pt`` checkpoint."""
    sd: Dict[str, torch.Tensor] = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = p["w"].t().contiguous()
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["g"], p["b"]

    def block(pre, bp, cross):
        ln(f"{pre}.attn_ln", bp["ln1"])
        for ours, theirs in zip("qkvo", ("query", "key", "value", "out")):
            lin(f"{pre}.attn.{theirs}", bp["attn"][ours])
            if cross:
                lin(f"{pre}.cross_attn.{theirs}", bp["cross"][ours])
        if cross:
            ln(f"{pre}.cross_attn_ln", bp["ln2"])
        ln(f"{pre}.mlp_ln", bp["ln3" if cross else "ln2"])
        lin(f"{pre}.mlp.0", bp["mlp"]["fc1"])
        lin(f"{pre}.mlp.2", bp["mlp"]["fc2"])

    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        sd[f"encoder.{c}.weight"], sd[f"encoder.{c}.bias"] = enc[c]["w"].contiguous(), enc[c]["b"]
    for i, bp in enumerate(enc["blocks"]):
        block(f"encoder.blocks.{i}", bp, cross=False)
    ln("encoder.ln_post", enc["ln_post"])
    sd["decoder.token_embedding.weight"] = dec["tok_emb"]
    sd["decoder.positional_embedding"] = dec["pos_emb"]
    for i, bp in enumerate(dec["blocks"]):
        block(f"decoder.blocks.{i}", bp, cross=True)
    ln("decoder.ln", dec["ln"])
    return sd


# --- entry point -----------------------------------------------------------
def load_checkpoint(path: str) -> Tuple[Params, ModelDims]:
    """Load a checkpoint → (port params on the CPU, dims): the ``.npz``
    interchange file of either package (``utils/checkpoint.py``), an
    openai-whisper ``.pt``/``.pth`` (``torch.load`` of a dict with ``dims``
    and ``model_state_dict``), or a HF directory (needs ``transformers``).
    The JAX package's Orbax directories are refused."""
    from whisper_tpu_torch.utils.checkpoint import load_params

    if path.endswith(".npz"):
        return load_params(path)
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "dims.json")):
        return load_params(path)  # raises: Orbax
    if path.endswith((".pt", ".pth")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        dims = dims_from_openai(ckpt["dims"])
        return from_openai_state_dict(ckpt["model_state_dict"], dims), dims
    try:
        from transformers import WhisperForConditionalGeneration
    except ImportError as e:
        raise RuntimeError(
            f"{path} is not an .npz or .pt file; loading it as a HuggingFace "
            "checkpoint needs the transformers package, which is not installed"
        ) from e
    model = WhisperForConditionalGeneration.from_pretrained(path)
    dims = dims_from_hf_config(model.config)
    return from_hf_state_dict(model.state_dict(), dims), dims
