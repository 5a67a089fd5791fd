"""Model dimension tables and engine configuration (copy of
``whisper_tpu/config.py``; the port keeps its own so that it imports
nothing of the JAX package).

The reference selects models by file-path convention (``prefix.tflite`` vs
``prefix.{encoder,decoder}.tflite`` — whisper.cpp:669,743-744) and has no
notion of architecture hyperparameters: they are baked into the flatbuffer
graph. Here the architecture is explicit: :class:`ModelDims` carries the
Whisper family hyperparameters and :class:`EngineConfig` unifies the
reference's three config tiers (CLI11 flags app/encdec.cpp:30-37, positional
argv app/minimal.cpp:22-34, env vars scripts/run.sh:3) into one dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --- Audio frontend constants (reference whisper.h:34-39) -------------------
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480_000 (whisper.cpp:687,698,753)
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3_000 mel frames (whisper.h:39)

# --- Text-side constants (reference whisper.h:41-42) ------------------------
N_VOCAB_ENGLISH = 51_864
N_VOCAB_MULTILINGUAL = 51_865
N_VOCAB_LARGE_V3 = 51_866  # large-v3 adds the <|yue|> language token
N_TEXT_CTX = 448
N_AUDIO_CTX = 1_500


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Whisper family architecture hyperparameters.

    Mirrors openai-whisper's ModelDimensions; the reference never names these
    because they live inside the exported graph (export/generate.py:13-30).
    """

    n_mels: int = 80
    n_audio_ctx: int = N_AUDIO_CTX
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = N_VOCAB_MULTILINGUAL
    n_text_ctx: int = N_TEXT_CTX
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= N_VOCAB_MULTILINGUAL


def _dims(state, head, layer, **kw) -> ModelDims:
    return ModelDims(
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer,
        **kw,
    )


MODEL_DIMS = {
    "tiny.en": _dims(384, 6, 4, n_vocab=N_VOCAB_ENGLISH),
    "tiny": _dims(384, 6, 4),
    "base.en": _dims(512, 8, 6, n_vocab=N_VOCAB_ENGLISH),
    "base": _dims(512, 8, 6),
    "small.en": _dims(768, 12, 12, n_vocab=N_VOCAB_ENGLISH),
    "small": _dims(768, 12, 12),
    "medium.en": _dims(1024, 16, 24, n_vocab=N_VOCAB_ENGLISH),
    "medium": _dims(1024, 16, 24),
    "large": _dims(1280, 20, 32),
    "large-v2": _dims(1280, 20, 32),
    "large-v3": _dims(1280, 20, 32, n_mels=128, n_vocab=N_VOCAB_LARGE_V3),
    "large-v3-turbo": _dims(1280, 20, 32, n_mels=128, n_vocab=N_VOCAB_LARGE_V3),
}
# turbo has 4 decoder layers
MODEL_DIMS["large-v3-turbo"] = dataclasses.replace(
    MODEL_DIMS["large-v3"], n_text_layer=4
)
# Distil-Whisper (distil-whisper/distil-large-v3 etc.): the full encoder
# with a 2-layer decoder — the production "fast large" family; the decode
# loop's per-step cost scales with n_text_layer, so these are ~16x lighter
# per token than their teachers on the decode-bound path.
MODEL_DIMS["distil-large-v3"] = dataclasses.replace(
    MODEL_DIMS["large-v3"], n_text_layer=2
)
MODEL_DIMS["distil-large-v2"] = dataclasses.replace(
    MODEL_DIMS["large-v2"], n_text_layer=2
)
MODEL_DIMS["distil-medium.en"] = dataclasses.replace(
    MODEL_DIMS["medium.en"], n_text_layer=2
)
MODEL_DIMS["distil-small.en"] = dataclasses.replace(
    MODEL_DIMS["small.en"], n_text_layer=4
)

# Development model: real vocab/context geometry, minimal width/depth — for
# CPU tests and CI where a real checkpoint would be needlessly slow.
MODEL_DIMS["dev"] = _dims(64, 2, 2)
MODEL_DIMS["dev.en"] = _dims(64, 2, 2, n_vocab=N_VOCAB_ENGLISH)


@dataclasses.dataclass(frozen=True)
class AudioLMDims:
    """A decoder-only language model over a Whisper encoder's output: the
    audio path of an omni model (Uni-MoE-2.0-Omni, HIT-TMG's
    ``config.json``). The tower's first ``audio_ctx`` positions are
    mean-pooled in groups of ``pool`` and projected to ``n_state``; the
    language model is RMSNorm, GQA with RoPE and q/k/v biases, and in every
    layer a mixture of experts: ``n_shared`` SwiGLU experts of
    ``shared_width`` on every token, ``n_routed`` of ``routed_width`` and
    ``n_null`` that return zero, chosen by an f32 softmax gate over the
    routed and null experts (the fewest whose probabilities reach
    ``top_p``, at most ``top_k``), weighted by their probabilities."""

    tower: ModelDims = dataclasses.field(default_factory=ModelDims)
    n_state: int = 3584
    n_layer: int = 28
    n_head: int = 28
    n_kv_head: int = 4
    head_dim: int = 128
    n_vocab: int = 152_064
    n_routed: int = 4
    n_null: int = 1
    n_shared: int = 2
    routed_width: int = 18_944
    shared_width: int = 2_368
    top_p: float = 0.7
    top_k: int = 2
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    audio_ctx: int = 1_000  # tower positions read: 20 s
    pool: int = 5  # tower positions per LM position
    stop: int = 151_645  # <|im_end|>
    n_ctx: int = 128_000


AUDIO_LM_DIMS = {
    "uni-moe-2.0-omni": AudioLMDims(tower=MODEL_DIMS["large-v3"]),
    # CPU tests: the same shape at a small size (GQA 7:1, 2 layers, a
    # 128-mel tower of 2 layers).
    "uni-moe-dev": AudioLMDims(
        tower=dataclasses.replace(MODEL_DIMS["dev"], n_mels=128, n_vocab=N_VOCAB_LARGE_V3),
        n_state=112, n_layer=2, n_head=7, n_kv_head=1, head_dim=16, n_vocab=512,
        routed_width=64, shared_width=24, stop=511,
    ),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One config object for the whole stack.

    Replaces the reference's scattered knobs: EngineType (whisper.h:199-204),
    multilingual flag (whisper.h:259-260), hardcoded language "de"
    (whisper.cpp:327-339), max_decoder_tokens=30 (whisper.cpp:364), and the
    interpreter thread count (whisper.cpp:718).
    """

    model: str = "tiny"
    language: Optional[str] = None  # None on a multilingual model => detect
    # per utterance (decode/language.py); ignored on .en models
    task: str = "transcribe"  # or "translate"
    beam_size: int = 1  # 1 => greedy (reference behavior, whisper.cpp:346-361)
    max_new_tokens: Optional[int] = None  # None => fill n_text_ctx budget
    timestamps: bool = False  # reference always sends <|notimestamps|>
    suppress_blank: bool = True
    suppress_nonspeech: bool = True
    batch_size: int = 1
    dtype: str = "bfloat16"  # compute dtype; "float32" for parity tests
    quantization: Optional[str] = None  # None | "int8" weight-only
    kv_cache_dtype: Optional[str] = None  # None => compute dtype;
    # "float8_e4m3fn" halves cross-KV + cache HBM (large-v3 cross-KV is the
    # single biggest activation block: ~250 MB/utterance in bf16)
    # Parallelism (reference: single-device; see SURVEY.md §2b)
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, model)
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    # Sampling + temperature fallback (openai-whisper transcribe semantics;
    # the reference is greedy-only). temperature=0 is exact greedy;
    # fallback_temperatures appends a retry ladder — failed quality gates
    # (decode/fallback.py) re-decode just the failing rows at the next
    # temperature. All temperatures share ONE executable (T is a traced
    # scalar; decode/greedy.py gumbel-argmax).
    temperature: float = 0.0
    fallback_temperatures: Optional[Tuple[float, ...]] = None
    compression_ratio_threshold: Optional[float] = 2.4  # gate: None disables
    logprob_threshold: Optional[float] = -1.0  # gate: None disables
    sampling_seed: int = 0
    # Word-level timestamps: DTW over cross-attention alignment
    # (decode/align.py) via one extra teacher-forced forward per batch.
    # alignment_heads: explicit [(layer, head), ...] (openai ships these per
    # checkpoint); None = all heads of the upper half of the decoder stack.
    word_timestamps: bool = False
    alignment_heads: Optional[Tuple[Tuple[int, int], ...]] = None
    # Conditioning context (openai initial_prompt): token IDs prepended as
    # [<|startofprev|>] + prefix before the SOT sequence, cropped to the
    # last n_text_ctx//2-1 entries. Token IDs, not text — tokenization is a
    # checkpoint-side concern (pair with the HF tokenizer used to convert).
    initial_prompt_tokens: Optional[Tuple[int, ...]] = None
    # Conditioning context as TEXT (openai's actual initial_prompt surface):
    # encoded with the built-in byte-level BPE encoder (tokenizer/bpe.py) as
    # " " + text.strip(), then treated exactly like initial_prompt_tokens.
    # Mutually exclusive with initial_prompt_tokens.
    initial_prompt: Optional[str] = None
    # Speculative decoding (decode/speculative.py): a draft model proposes
    # k_draft tokens per round and the target verifies the window in one
    # forward — output bit-identical to plain greedy for ANY draft; the
    # speedup scales with draft/target agreement (Distil-Whisper drafts are
    # the intended pairing and share the teacher's encoder). Greedy-only
    # (beam_size 1, no sampling); transcribe_sequential does not use the
    # draft (its per-window programs decode plain greedy). None = off.
    draft_model: Optional[str] = None
    k_draft: int = 4
    # Additive logit biases, token id → bias (the openai-API logit_bias
    # surface): applied to every decode step's logits before rules and
    # selection, on every decode path (greedy, beam, sampling, continuous
    # slots). Positive boosts, negative soft-suppressions; e.g.
    # {eot_id: +4.0} shortens generations.
    logit_bias: Optional[Tuple[Tuple[int, float], ...]] = None
    # Silence gate (openai no_speech_threshold, default there 0.6): when
    # set, the <|nospeech|> probability at the SOT position is read from the
    # prefill logits; a window with prob > threshold is emitted as empty
    # text — unless avg_logprob clears logprob_threshold (confident speech
    # overrides the gate, openai transcribe.py). None = off (parity path).
    no_speech_threshold: Optional[float] = None
    # KV segment-growth granularity of the JAX package's decode loop. The
    # port decodes into one preallocated cache; its outputs equal every
    # setting of this knob, so it is accepted and ignored.
    ctx_bucket: object = "auto"
    # Beam decode-step mode (decode/beam.py resolve_fused): "auto" (K2's
    # "hybrid" on the card, "off" on the CPU), "hybrid", "lineage" or "off"
    # (eager step + K4 cache reorder); True/False = "hybrid"/"off".
    fused_step: object = "auto"
    # Host→device audio width: "int16" (default) ships batches at the WAV's
    # native 16-bit width and converts on device (exact inverse of wav.py's
    # read scale — bit-identical for WAV/PCM-sourced audio, nearest-step
    # quantization for synthetic float input); "float32" ships floats.
    audio_transfer_dtype: str = "int16"
    # Encoder-context crop (the reference family's audio_ctx knob,
    # whisper.cpp main: -ac): keep only the first N of the 1500 encoder
    # positions for cross-attention (and everything downstream of it —
    # decode and language detection). Applied POST-encoder (the encoder's
    # representation is unchanged), so N=1500/None is exactly the uncropped
    # pipeline. "auto" (default) derives N per batch from the audio content
    # — the last non-zero sample across the batch rows, + a 32-frame
    # (0.64 s) silence margin — snapped UP to a small bucket menu
    # (engine.AUDIO_CTX_BUCKETS: 256, 512, 1024, full). Cropping
    # trailing-silence context is a documented numeric deviation from
    # openai's fixed 30 s window; audio_ctx=None restores it.
    audio_ctx: object = "auto"
    # Bit-parity mode vs the reference binaries: reproduces its literal
    # multilingual prompt (unshifted task/notimestamps IDs 50359/50363 —
    # whisper.cpp:331-339) and the stereo downmix-by-INT32_MAX bug
    # (wav_util.cpp:122-126). Off by default: real checkpoints expect the
    # true multilingual token IDs and a sane downmix.
    reference_quirks: bool = False
    # An audio language model (AUDIO_LM_DIMS): the text ids before and
    # after the audio positions of every prompt (its chat template's ids).
    lm_prefix_tokens: Tuple[int, ...] = ()
    lm_suffix_tokens: Tuple[int, ...] = ()

    def dims(self) -> ModelDims:
        return MODEL_DIMS[self.model]

    @property
    def multilingual(self) -> bool:
        return not self.model.endswith(".en")
