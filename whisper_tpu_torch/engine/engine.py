"""Engine API: ``create_engine`` → ``Monolith`` / ``EncDec`` → ``transcribe``.

Counterpart of ``whisper_tpu/engine/engine.py`` for the static-batch
path: int16 audio shipping, the ``audio_ctx="auto"`` crop, log-mel,
encoder (with K1), language detection when ``language=None`` on a
multilingual model, greedy or beam decode (``beam_size > 1``, step mode
``fused_step``: K2 on the card's "hybrid") with the suppress rules,
int8 weights (``quantization="int8"``, quantized at construction) and
the fp8 KV cache (``kv_cache_dtype``), detokenize. The port runs
eagerly, so the two engine kinds differ only in what they time:
``Monolith`` reports the whole run as ``model_ms``; ``EncDec`` reports the
frontend and encoder as ``mel_ms`` and the decode as ``model_ms``.

On top of that one run, as in JAX:

* **the temperature fallback ladder** (``temperature``,
  ``fallback_temperatures``, the two quality gates of
  ``decode/fallback.py``): rows that fail a gate are decoded again, as
  one bucketed sub-batch, at the next temperature through the sampler of
  ``decode/greedy.py``; the last attempt is kept. Each attempt of each
  call draws from a fresh ``torch.Generator`` on the engine's device,
  seeded from ``(sampling_seed, attempt, rank)``: the same engine called
  twice gives the same tokens. The noise stream is the device's (Philox
  on CUDA, MT19937 on the CPU), not JAX's;
* **word timestamps** (``word_timestamps=True``): one teacher-forced
  alignment forward per ``transcribe_batch`` on the final tokens
  (``decode/align.py``), over the primary run's encoder output (the same
  rows of the same padded batch: JAX's separate program encodes them again
  to the same values), then the DTW on the host;
* **long form**: :meth:`Engine.transcribe_long` (VAD chunks of ≤ 30 s
  as one batch) and :meth:`Engine.transcribe_sequential` (openai's seek
  loop with previous-text conditioning, ``decode/sequential.py``);
* **speculative decoding** (``draft_model``, ``k_draft``; greedy only):
  ``decode/speculative.py`` with the draft's weights (``draft_params``, or
  random from a seeded generator). A draft whose encoder geometry equals
  the target's (the distil-* pairings) reuses the target's encoder
  output; any other draft runs its own log-mel and encoder on the same
  samples and crop in ``Monolith`` (``EncDec`` refuses it). Its results
  carry no ``avg_logprob``; ``transcribe_sequential`` and the slot pools
  decode without the draft, as in JAX;
* **``initial_prompt`` text**, encoded by ``tokenizer/bpe.py``;
* **the batch stream** (:meth:`Monolith.transcribe_batches`): batch i+1's
  copy and encode are enqueued on side streams before batch i's decode,
  and batch i's results are built while the card works.

``mesh_shape=(d, m)`` runs the engine as one rank of a world of d · m
processes (``parallel/``, over gloo), ranks numbered with the model axis
innermost. Along ``data`` each group of m ranks encodes and decodes its
contiguous share of the batch (beam "hybrid" through K2′ where m = 1), and
every rank returns the full, ordered result list. Along ``model`` the m
ranks of a group hold the model between them (Megatron tensor parallelism,
``parallel/sharding.py``): the weights are quantised whole, then cut, then
moved to the device; every layer runs on the rank's heads and the layers
all-reduce over the group (``parallel/collectives.py``), so every rank of
the group decodes the same tokens. A rank restored from an npz holds only
its slice from the start (``utils/checkpoint.load_params`` with the mesh;
``shard=`` here). A speculative draft stays whole on
every rank, as in JAX. ``transcribe_files`` reads on each data rank only
its files (with the native loader when it is built, ``native/``).

Each batch records spans (``utils/profiling``) while a profiler session
has started: a root ``engine.batch`` with its number as the trace id, over
``engine.prepare``, ``engine.encode`` and ``decode.prompts`` (both timed
on the card too), the decode loop's spans, ``engine.fetch`` and
``engine.results``.

Entry points take ``device=`` and default to ``"cuda"``: asking for CUDA
where there is none raises, and the CPU runs only when asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_tpu_torch.audio.vad import speech_segments
from whisper_tpu_torch.audio.wav import read_pcm_f32, read_wav, read_wav_legacy
from whisper_tpu_torch.config import MODEL_DIMS, N_SAMPLES, EngineConfig, ModelDims
from whisper_tpu_torch.decode.align import (
    alignment_matrix,
    default_alignment_mask,
    heads_to_mask,
    words_from_alignment,
)
from whisper_tpu_torch.decode import beam as beam_mod
from whisper_tpu_torch.decode import greedy as greedy_mod
from whisper_tpu_torch.decode.beam import beam_decode
from whisper_tpu_torch.decode.fallback import compression_ratio, needs_fallback, normalize_schedule
from whisper_tpu_torch.decode.greedy import greedy_decode
from whisper_tpu_torch.decode.language import detect_language_tokens, lang_token_to_code
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.decode.prompt import build_prompt
from whisper_tpu_torch.decode.segments import parse_segments
from whisper_tpu_torch.decode.sequential import crop_prefix, window_emit_and_advance
from whisper_tpu_torch.decode.speculative import speculative_greedy_decode
from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram
from whisper_tpu_torch.models.decoder import precompute_cross_kv
from whisper_tpu_torch.models.encoder import encode
from whisper_tpu_torch.models.params import Params, init_params, to_device
from whisper_tpu_torch.models.quantize import is_quantized, quantize_params
from whisper_tpu_torch.parallel.mesh import make_mesh, rank_device
from whisper_tpu_torch.parallel.multihost import (
    allgather_rows,
    data_processes,
    host_shard,
    load_files_sharded,
    read_files,
    uniform_host_rows,
    world_size,
)
from whisper_tpu_torch.parallel.sharding import shard_params
from whisper_tpu_torch.tokenizer.binfmt import read_bin
from whisper_tpu_torch.tokenizer.bpe import encode_initial_prompt
from whisper_tpu_torch.tokenizer.detokenize import decode_tokens, remove_extra_spaces
from whisper_tpu_torch.tokenizer.languages import lang_code
from whisper_tpu_torch.tokenizer.vocab import Vocab, num_languages_for
from whisper_tpu_torch.utils.profiling import (
    StageTimer,
    Throughput,
    annotate,
    next_number,
    next_span_id,
    record,
    scope,
)


def _samples_f32(x: torch.Tensor) -> torch.Tensor:
    """Shipped samples → float32 on their device: int16 with the exact
    inverse of wav.py's int16/32768 read scale, float32 as they are."""
    return x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x


class EngineType(enum.IntEnum):
    """whisper.h:199-204."""

    MONOLITH = 0
    ENCDEC = 1


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    tokens: np.ndarray  # [total_len] int32, prompt included
    length: int  # valid tokens incl. terminating EOT
    language: str = ""  # ISO code (configured, or detected when autodetecting)
    segments: Optional[list] = None  # [Segment] when timestamps=True
    mel_ms: Optional[float] = None  # EncDec: frontend + encoder time
    model_ms: float = 0.0
    no_speech_prob: Optional[float] = None  # <|nospeech|> prob at SOT
    is_silent: bool = False  # no-speech gate fired: text forced empty
    # beam: the length-normalised score; sampling: mean logprob per
    # generated token (terminating EOT included)
    avg_logprob: Optional[float] = None
    compression_ratio: Optional[float] = None  # zlib repetition gauge (sampling on)
    temperature: Optional[float] = None  # the temperature of the kept attempt
    words: Optional[list] = None  # [align.Word] when word_timestamps=True

    def clean_text(self) -> str:
        return remove_extra_spaces(self.text)


@dataclasses.dataclass
class LongTranscriptionResult:
    """Result of :meth:`Engine.transcribe_long`: chunk results in time order
    with their window offsets (seconds) into the original audio."""

    text: str
    offsets: List[float]
    chunks: List[TranscriptionResult]


def decode_steps() -> int:
    """Single-token decode steps run in this process, beam and greedy
    (``decode.beam.steps`` + ``decode.greedy.steps``)."""
    return beam_mod.steps + greedy_mod.steps


def batch_bucket(b: int) -> int:
    """Next power of two ≥ b: the batch sizes a run pads to, so the set of
    shapes the device sees stays logarithmic in the largest batch."""
    return 1 << max(b - 1, 0).bit_length()


# audio_ctx="auto" menu: encoder-position crops derived from the batch's
# content, snapped up to these buckets (plus the full window). Margin: 32
# positions = 0.64 s of trailing silence kept as context.
AUDIO_CTX_BUCKETS = (256, 512, 1024)
AUDIO_CTX_MARGIN = 32
_SAMPLES_PER_POS = 320  # hop 160 x encoder conv stride 2


def last_content_index(batch: np.ndarray, chunk: int = 16384) -> int:
    """Index of the last non-zero sample column of a [B, N] host batch, or
    -1 for all-silence. Scans column chunks from the END, so a typical batch
    touches one chunk."""
    n = batch.shape[-1]
    for end in range(n, 0, -chunk):
        start = max(0, end - chunk)
        seg = batch[:, start:end]
        if seg.any():
            cols = np.flatnonzero(np.any(seg != 0, axis=0))
            return start + int(cols[-1])
    return -1


def snap_audio_ctx(last_idx: int, full: int) -> Optional[int]:
    """Map the last content sample index to the covering crop bucket
    (None = full window)."""
    frames = (last_idx // _SAMPLES_PER_POS + 1) if last_idx >= 0 else 1
    need = frames + AUDIO_CTX_MARGIN
    for b in AUDIO_CTX_BUCKETS:
        if need <= b < full:
            return b
    return None


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. CUDA must exist when asked for:
    there is no quiet drop to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass
class _Assets:
    params: Params
    dims: ModelDims
    vocab: Vocab
    mel_filters: np.ndarray
    # (model index, model size) of the slice ``params`` holds; None: whole
    shard: Optional[Tuple[int, int]] = None


class Engine:
    """Abstract engine (whisper.h:159-163): transcribe float samples or a
    wave file, one utterance or a batch."""

    def __init__(
        self,
        assets: _Assets,
        config: EngineConfig,
        device: Union[str, torch.device] = "cuda",
        draft_params: Optional[Params] = None,
    ):
        if config.quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization: {config.quantization!r}")
        self.device = resolve_device(device)
        # A mesh: this process is one rank of it, on its device.
        self.mesh = None
        if int(np.prod(config.mesh_shape)) > 1:
            self.mesh = make_mesh(
                tuple(config.mesh_shape), tuple(config.mesh_axis_names), device=self.device
            )
            self.device = self.mesh.device
        self.config = config
        self.dims = assets.dims
        self.vocab = assets.vocab
        self._compute_dtype = getattr(torch, config.dtype)
        self._kv_dtype = getattr(torch, config.kv_cache_dtype) if config.kv_cache_dtype else None
        params = assets.params
        tp = self.mesh is not None and self.mesh.model_size > 1
        if not tp:
            params = to_device(params, self.device)  # quantised on the device
        shard = assets.shard  # a restored slice, or this rank's engine built again on its assets
        if config.quantization == "int8" and not is_quantized(params):
            if shard is not None:
                raise ValueError(
                    "a float model slice cannot be quantised (a row-parallel weight's scale "
                    "spans the whole d_in): restore it with quantization='int8' "
                    "(utils/checkpoint.load_params)"
                )
            params = quantize_params(params)  # the whole tree, before any cut
        here = (self.mesh.model_index, self.mesh.model_size) if tp else None
        if shard is not None and shard != here:
            raise ValueError(
                f"assets hold the model slice {shard} (index, size), but this engine's "
                f"rank needs {here if tp else 'the whole model'}"
            )
        if tp and shard is None:
            params = shard_params(params, self.mesh, self.dims)
            shard = here
        params = to_device(params, self.device)
        assets = dataclasses.replace(assets, params=params, shard=shard)
        self.assets = assets
        # language=None on a multilingual model → per-utterance detection.
        self._autodetect = config.language is None and config.multilingual
        if config.initial_prompt is not None and config.initial_prompt_tokens:
            raise ValueError(
                "initial_prompt (text) and initial_prompt_tokens (ids) are "
                "mutually exclusive"
            )
        prefix_tokens = list(config.initial_prompt_tokens) if config.initial_prompt_tokens else None
        if config.initial_prompt is not None:
            prefix_tokens = encode_initial_prompt(assets.vocab, config.initial_prompt)
        prompt = build_prompt(
            multilingual=config.multilingual,
            language=config.language or "en",
            task=config.task,
            timestamps=config.timestamps,
            specials=assets.vocab.specials,
            reference_quirks=config.reference_quirks,
            prefix_tokens=prefix_tokens,
            n_text_ctx=self.dims.n_text_ctx,
        )
        self._prompt = np.asarray(prompt, dtype=np.int32)
        self._prompt_dev = {}  # device → the template there (_prompt_on)
        # Index of SOT within the prompt (> 0 when an initial-prompt prefix
        # precedes it); the language slot is always sot_index + 1.
        self._sot_index = int(np.nonzero(self._prompt == assets.vocab.specials.sot)[0][0])
        budget = self.dims.n_text_ctx - len(prompt)
        self._max_new = (
            min(config.max_new_tokens, budget)
            if config.max_new_tokens is not None
            else budget
        )
        self._filters = torch.tensor(assets.mel_filters, device=self.device)
        if config.suppress_blank or config.suppress_nonspeech or config.timestamps:
            self._rules = make_rules(
                assets.vocab,
                timestamps=config.timestamps,
                suppress_blank=config.suppress_blank,
                suppress_nonspeech=config.suppress_nonspeech,
                n_vocab=self.dims.n_vocab,
            )
        else:
            self._rules = None  # raw reference behavior (whisper.cpp:382-383)
        if config.logit_bias:
            pairs = (
                config.logit_bias.items()
                if isinstance(config.logit_bias, dict)
                else config.logit_bias
            )
            lb = np.zeros(self.dims.n_vocab, np.float32)
            for tid, bias in pairs:
                lb[int(tid)] += float(bias)
            self._logit_bias = torch.from_numpy(lb).to(self.device)
        else:
            self._logit_bias = None
        # Sampling and the temperature fallback (decode/fallback.py).
        if config.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if config.temperature > 0 and config.beam_size > 1:
            raise ValueError(
                "beam search decodes at temperature 0; temperature > 0 "
                "requires beam_size=1 (openai-whisper semantics: fallback "
                "retries switch from beam to sampling)"
            )
        self._schedule = normalize_schedule(config.temperature, config.fallback_temperatures)
        # The sampler runs when the primary decode samples (T > 0) or a retry
        # ladder exists; a beam primary still decodes by beam, and only its
        # retries sample.
        self._sampling_on = config.temperature > 0 or len(self._schedule) > 1
        self._sampling_primary = self._sampling_on and config.beam_size == 1
        # Word-level timestamps (decode/align.py): the selected heads.
        self._align_mask = None
        if config.word_timestamps:
            self._align_mask = (
                heads_to_mask(config.alignment_heads, self.dims)
                if config.alignment_heads is not None
                else default_alignment_mask(self.dims)
            )
        self._init_draft(draft_params)
        # Stage times and throughput counters (utils/profiling.py), recorded
        # by transcribe_batch and read by the HTTP server's /metrics.
        self.timer = StageTimer()
        self.throughput = Throughput()

    def _init_draft(self, draft_params: Optional[Params]) -> None:
        """Speculative decoding's draft (``config.draft_model``): greedy
        only; its weights on the engine's device, int8 when the target's
        are; whether it shares the target's encoder output."""
        config = self.config
        self._draft_params = None
        self.last_spec_stats = None  # the last speculative decode's stats
        if config.draft_model is None:
            return
        if config.beam_size > 1 or self._sampling_on:
            raise ValueError(
                "speculative decoding is greedy-only: draft_model "
                "requires beam_size=1 and no sampling/fallback schedule"
            )
        self._draft_dims = MODEL_DIMS[config.draft_model]
        if draft_params is None:
            # A random draft (tests, benchmarks): the output is the target's
            # greedy decode all the same; only the speed suffers.
            gen = torch.Generator(device=self.device).manual_seed(1)
            draft_params = init_params(
                self._draft_dims, gen, dtype=self._compute_dtype, device=self.device
            )
        draft_params = to_device(draft_params, self.device)
        if config.quantization == "int8" and not is_quantized(draft_params):
            draft_params = quantize_params(draft_params)
        self._draft_params = draft_params
        dd = self._draft_dims
        self._draft_share_encoder = (
            dd.n_audio_state == self.dims.n_audio_state
            and dd.n_mels == self.dims.n_mels
            and dd.n_audio_ctx == self.dims.n_audio_ctx
        )
        if not self._draft_share_encoder:
            self._draft_filters = torch.tensor(mel_filterbank(n_mels=dd.n_mels), device=self.device)

    # --- stages ------------------------------------------------------------
    def _encode(self, batch: np.ndarray, audio_ctx: Optional[int]) -> torch.Tensor:
        """Host rows → encoder output on the device, cropped to
        ``audio_ctx`` positions (None: the full window; see
        :meth:`_resolve_audio_ctx`)."""
        return self._encoder_output(self._place_batch(batch), audio_ctx)

    def _encoder_output(
        self, samples: torch.Tensor, audio_ctx: Optional[int], draft: bool = False
    ) -> torch.Tensor:
        """Samples on the device → log-mel → encoder output, cropped to
        ``audio_ctx``; the target's, or with ``draft`` the draft's own
        (its filterbank, its encoder)."""
        params, dims, filters = (
            (self._draft_params, self._draft_dims, self._draft_filters) if draft
            else (self.assets.params, self.dims, self._filters)
        )
        with annotate("engine.encode", device=samples.device, rows=samples.shape[0]):
            mel = log_mel_spectrogram(
                samples, filters, n_mels=dims.n_mels, compute_dtype=torch.float32
            )
            enc_out = encode(
                params, mel.to(self._compute_dtype), dims, tp=None if draft else self.mesh
            )
        if audio_ctx is not None and audio_ctx < enc_out.shape[1]:
            enc_out = enc_out[:, :audio_ctx]
        return enc_out

    def _make_prompts(self, params: Params, enc_out: torch.Tensor):
        """Batch prompts on ``enc_out``'s device: the static template, with
        the language slot filled by detection when autodetecting. Returns
        (prompts [B, P], cross_kv or None); detection's cross-KV is shared
        with the decode. ``params`` are the engine's, or their replica on
        a disaggregated encoder's device."""
        b = enc_out.shape[0]
        with annotate("decode.prompts", device=enc_out.device):
            prompts = self._prompt_on(enc_out.device)[None, :].repeat(b, 1)
            if not self._autodetect:
                return prompts, None
            cross_kv = precompute_cross_kv(
                params, enc_out, self.dims, kv_dtype=self._kv_dtype, tp=self.mesh
            )
            lang_toks = detect_language_tokens(
                params,
                enc_out,
                self.dims,
                sot=self.vocab.specials.sot,
                compute_dtype=self._compute_dtype,
                cross_kv=cross_kv,
                tp=self.mesh,
            )
            prompts[:, self._sot_index + 1] = lang_toks
        return prompts, cross_kv

    def _prompt_on(self, device: torch.device) -> torch.Tensor:
        """The prompt template on ``device`` (int64), uploaded once per
        device: a copy from pageable host memory waits for the card, which
        an encode enqueued ahead of a decode must not do."""
        if device not in self._prompt_dev:
            self._prompt_dev[device] = torch.from_numpy(self._prompt).to(device, torch.long)
        return self._prompt_dev[device]

    def _decode(
        self,
        enc_out: torch.Tensor,
        temperature: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        draft_enc: Optional[torch.Tensor] = None,
        prompts: Optional[tuple] = None,
    ):
        """Greedy, beam, sampling or speculative decode → (tokens, lengths,
        avg_logprob or None, no_speech probs or None). Beam rows report their
        length-normalised score as avg_logprob; speculative rows none.
        ``draft_enc``: the draft's own encoder output (None: it shares
        ``enc_out``). ``prompts``: :meth:`_make_prompts`' (prompts,
        cross_kv), made ahead by the batch stream's encode (None: made
        here).

        ``temperature`` (with ``generator``) forces the sampler whatever the
        beam size: openai's fallback semantics, where beam applies at T = 0
        only and retries sample. Its avg_logprob is the mean logprob per
        generated token (terminating EOT included), the quantity the
        fallback's logprob gate reads."""
        prompts, cross_kv = prompts or self._make_prompts(self.assets.params, enc_out)
        ns = (
            (self._sot_index, self.vocab.specials.nospeech)
            if self.config.no_speech_threshold is not None
            else None
        )
        common = dict(
            dims=self.dims,
            eot=self.vocab.specials.eot,
            max_new_tokens=self._max_new,
            logit_bias=self._logit_bias,
            rules=self._rules,
            compute_dtype=self._compute_dtype,
            cross_kv=cross_kv,
            kv_cache_dtype=self._kv_dtype,
            no_speech=ns,
        )
        if temperature is not None:
            out = greedy_decode(
                self.assets.params, enc_out, prompts, temperature=temperature,
                generator=generator, return_logprobs=True, mesh=self.mesh, **common,
            )
            tokens, lengths, sum_lp = out[:3]
            generated = (lengths - prompts.shape[1]).clamp(min=1).float()
            return tokens, lengths, sum_lp / generated, out[3] if ns else None
        if self._draft_params is not None:
            out = speculative_greedy_decode(
                self.assets.params, self._draft_params, enc_out, prompts,
                self.dims, self._draft_dims, eot=self.vocab.specials.eot,
                max_new_tokens=self._max_new, k_draft=self.config.k_draft,
                enc_out_d=draft_enc, logit_bias=self._logit_bias, rules=self._rules,
                compute_dtype=self._compute_dtype, kv_cache_dtype=self._kv_dtype,
                no_speech=ns, cross_kv_t=cross_kv, mesh=self.mesh,
            )
            self.last_spec_stats = out[2]
            return out[0], out[1], None, out[3] if ns else None
        if self.config.beam_size > 1:
            out = beam_decode(
                self.assets.params, enc_out, prompts, beam_size=self.config.beam_size,
                fused=self.config.fused_step, mesh=self.mesh, **common,
            )
            return out[0], out[1], out[2], out[3] if ns else None
        out = greedy_decode(self.assets.params, enc_out, prompts, mesh=self.mesh, **common)
        return out[0], out[1], None, out[2] if ns else None

    def _generator(self, attempt: int) -> torch.Generator:
        """The noise source of one attempt of one ``transcribe_batch`` call:
        a fresh generator on the engine's device seeded from
        ``(sampling_seed, attempt, rank)`` (JAX folds the attempt into
        ``PRNGKey(sampling_seed)``; the rank keeps the ranks' rows from
        drawing the same noise; the ranks of one model group hold the same
        rows and draw the same noise)."""
        rank = self.mesh.data_index if self.mesh is not None else 0
        seed = np.random.SeedSequence([self.config.sampling_seed, attempt, rank])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0])
        )

    def _run(
        self,
        batch: np.ndarray,
        audio_ctx: Optional[int],
        temperature: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One device run of this rank's rows → (tokens, lengths,
        avg_logprob or None, no_speech probs or None) of every rank's rows
        on the host (:meth:`_to_host`), plus (mel_ms, model_ms) and this
        rank's encoder output (on the device, for the alignment forward).
        ``temperature`` and ``generator``: see :meth:`_decode`."""
        raise NotImplementedError

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_host(self, outs) -> list:
        """Device → host, across the ranks on a mesh: every rank ends up with
        every rank's rows, in rank order. Token ids and lengths come back as
        int32, as in JAX."""
        with annotate("engine.fetch"):
            host = [
                None if x is None else (x.int() if not x.is_floating_point() else x).cpu().numpy()
                for x in outs
            ]
            if self.mesh is None:
                return host
            return [None if x is None else allgather_rows(x, self.mesh) for x in host]

    # --- host side ---------------------------------------------------------
    def _prepare_batch(self, samples: np.ndarray):
        """Pad/truncate to the 30 s window and bucket the batch axis.
        Returns (host batch [padded_b, N_SAMPLES], true rows b, valid
        samples n)."""
        b = samples.shape[0]
        padded_b = self._bucket(b)
        n = min(samples.shape[1], N_SAMPLES)
        if self.config.audio_transfer_dtype == "int16":
            # Ship audio at the WAV's native width; _place_batch converts on
            # the device. Exact for int16-sourced audio (wav.py reads
            # i/32768); float input quantizes to the nearest int16 step.
            batch = np.zeros((padded_b, N_SAMPLES), dtype=np.int16)
            x = np.multiply(samples[:, :n], 32768.0, dtype=np.float32)
            np.rint(x, out=x)
            np.clip(x, -32768, 32767, out=x)
            batch[:b, :n] = x.astype(np.int16)
        else:
            batch = np.zeros((padded_b, N_SAMPLES), dtype=np.float32)
            batch[:b, :n] = samples[:, :n]  # resize-to-480000 (whisper.cpp:687,698)
        return batch, b, n

    def _place_batch(self, batch: np.ndarray) -> torch.Tensor:
        """Host batch → float32 samples on the device. int16 batches ship as
        int16 and convert on the device with the exact inverse of wav.py's
        int16/32768 read scale."""
        return _samples_f32(torch.from_numpy(batch).to(self.device))

    def _resolve_audio_ctx(self, batch: Optional[np.ndarray]) -> Optional[int]:
        """``config.audio_ctx`` (None | int | "auto") → the crop for this
        batch (None = full window). "auto" reads the last non-zero sample
        column of the prepared host batch: the global batch, which every
        rank holds, so all ranks crop alike. Without a batch (None: the
        multi-process file path, where a rank holds only its own rows)
        "auto" is the full window, for the same reason."""
        ac = self.config.audio_ctx
        full = self.dims.n_audio_ctx
        if ac is None:
            return None
        if ac != "auto":
            ac = int(ac)
            return ac if ac < full else None
        if batch is None:
            return None
        return snap_audio_ctx(last_content_index(np.asarray(batch)), full)

    def _read_audio(self, path: str) -> np.ndarray:
        if path.endswith(".pcm") or path.endswith(".raw"):
            return read_pcm_f32(path)
        try:
            return read_wav(path, reference_quirks=self.config.reference_quirks)
        except ValueError:
            return read_wav_legacy(path)

    # --- public API --------------------------------------------------------
    def transcribe(
        self, audio: Union[str, np.ndarray], omit_special_tokens: bool = True
    ) -> TranscriptionResult:
        if isinstance(audio, str):
            samples = self._read_audio(audio)
        else:
            samples = np.asarray(audio, dtype=np.float32)
        return self.transcribe_batch(samples[None, :], omit_special_tokens)[0]

    def transcribe_batch(
        self,
        samples: np.ndarray,  # [B, n] float32, any n (padded/truncated to 30 s)
        omit_special_tokens: bool = True,
    ) -> List[TranscriptionResult]:
        """On a mesh every rank passes the whole batch, decodes its share
        and returns every row's result.

        With a fallback ladder, the rows that fail a quality gate are decoded
        again at each next temperature (openai-whisper
        ``decode_with_fallback``, over the batch): they are gathered into a
        ``batch_bucket`` sub-batch, whose "auto" crop is its own, and the
        last attempt is kept even if it still fails. With word timestamps,
        one alignment forward runs on the final tokens."""
        with annotate("engine.batch", trace_id=next_number()) as root:
            with annotate("engine.prepare"):
                batch, b, n = self._prepare_batch(np.asarray(samples, dtype=np.float32))
                ac = self._resolve_audio_ctx(batch)
            steps0 = decode_steps()
            primary_t = self._schedule[0] if self._sampling_primary else None
            local = self._local(batch)
            encoder_rows = local.shape[0]
            tokens, lengths, avg_lp, nsp, mel_ms, model_ms, enc_out = self._run(
                local, ac, temperature=primary_t,
                generator=None if primary_t is None else self._generator(0),
            )
            with annotate("engine.results"):
                # Writable copies: the retries patch rows in place.
                tokens, lengths = np.array(tokens), np.array(lengths)
                avg_lp = None if avg_lp is None else np.array(avg_lp)
                nsp = None if nsp is None else np.array(nsp)
                temps = np.full(batch.shape[0], self._schedule[0], np.float64)
                pending = self._failing(tokens, lengths, avg_lp, range(b))

            for attempt, temp in enumerate(self._schedule[1:], start=1):
                if not pending:
                    break
                sub = np.zeros((self._bucket(len(pending)), N_SAMPLES), dtype=batch.dtype)
                sub[: len(pending)] = batch[pending]
                local = self._local(sub)
                encoder_rows += local.shape[0]
                r_tok, r_len, r_lp, r_nsp, _, r_ms, _ = self._run(
                    local, self._resolve_audio_ctx(sub), temperature=temp,
                    generator=self._generator(attempt),
                )
                with annotate("engine.results"):
                    model_ms += r_ms
                    # The retry also refreshes no_speech_prob (the prefill does not
                    # depend on the temperature; kept in step with openai's result).
                    for j, i in enumerate(pending):
                        tokens[i], lengths[i] = r_tok[j], r_len[j]
                        avg_lp[i] = r_lp[j]
                        if nsp is not None:
                            nsp[i] = r_nsp[j]
                        temps[i] = temp
                    pending = self._failing(tokens, lengths, avg_lp, pending)

            words = [None] * b
            align_ms = 0.0
            if self._align_mask is not None:
                t0 = time.perf_counter()
                matrix = self._alignment(enc_out, tokens)
                t1 = time.perf_counter()
                n_frames = max(2, (n // 160) // 2)  # valid encoder positions
                if ac is not None:
                    n_frames = min(n_frames, ac)
                for i in range(b):
                    words[i] = words_from_alignment(
                        self.vocab, tokens[i], int(lengths[i]), len(self._prompt), matrix[i],
                        n_frames=n_frames,
                    )
                align_ms = (time.perf_counter() - t0) * 1e3
                self.timer.record("align", t1 - t0)
                self.timer.record("dtw", time.perf_counter() - t1)
            del enc_out

            with annotate("engine.results"):
                if mel_ms:
                    self.timer.record("mel", mel_ms / 1e3)
                self.timer.record("model", model_ms / 1e3)
                self.throughput.add(
                    audio_seconds=b * (n / 16_000.0),
                    tokens=int(np.sum(lengths[:b])),
                    utterances=b,
                    wall_s=((mel_ms or 0.0) + model_ms + align_ms) / 1e3,
                )
                results = [
                    self.result_from_tokens(
                        tokens[i], int(lengths[i]), omit_special_tokens,
                        mel_ms=mel_ms, model_ms=model_ms,
                        no_speech_prob=None if nsp is None else float(nsp[i]),
                        avg_logprob=None if avg_lp is None else float(avg_lp[i]),
                        temperature=float(temps[i]) if self._sampling_on else None,
                        words=words[i],
                    )
                    for i in range(b)
                ]
            root.set(rows=b, padded_rows=batch.shape[0],
                     audio_ctx=self.dims.n_audio_ctx if ac is None else ac,
                     steps=decode_steps() - steps0, encoder_rows=encoder_rows)
        return results

    def _local(self, batch: np.ndarray) -> np.ndarray:
        """This rank's rows of a global host batch (all of it off a mesh)."""
        return batch if self.mesh is None else self.mesh.local_rows(batch)

    def _bucket(self, rows: int) -> int:
        """The padded row count of a run of ``rows`` rows: the batch bucket,
        rounded up to whole equal shares on a mesh."""
        padded = batch_bucket(rows)
        if self.mesh is not None:
            d = self.mesh.data_size
            padded = -(-padded // d) * d
        return padded

    def _failing(self, tokens, lengths, avg_lp, rows) -> List[int]:
        """The rows among ``rows`` whose decode fails a quality gate
        (:func:`decode.fallback.needs_fallback`); none without a ladder."""
        if len(self._schedule) < 2:
            return []
        return [
            i for i in rows
            if needs_fallback(
                decode_tokens(self.vocab, tokens[i][self._sot_index : int(lengths[i])], True),
                None if avg_lp is None else float(avg_lp[i]),
                self.config.compression_ratio_threshold,
                self.config.logprob_threshold,
            )
        ]

    def _alignment(self, enc_out: torch.Tensor, tokens: np.ndarray) -> np.ndarray:
        """The alignment forward on the final tokens of every row ([B, T]
        host, every rank's) over this rank's encoder output → [B, T, Ta]
        f32 on the host: each rank aligns its own rows, and the matrices
        are gathered like the tokens."""
        cross_kv = precompute_cross_kv(
            self.assets.params, enc_out, self.dims, kv_dtype=self._kv_dtype, tp=self.mesh
        )
        toks = torch.from_numpy(self._local(np.asarray(tokens))).to(self.device, torch.long)
        matrix = alignment_matrix(
            self.assets.params, toks, cross_kv, self.dims, self._align_mask,
            compute_dtype=self._compute_dtype, tp=self.mesh,
        ).cpu().numpy()
        return matrix if self.mesh is None else allgather_rows(matrix, self.mesh)

    def transcribe_batches(
        self, batches: Sequence[np.ndarray], omit_special_tokens: bool = True
    ) -> List[List[TranscriptionResult]]:
        """Transcribe a sequence of batches, one after the other."""
        return [self.transcribe_batch(b, omit_special_tokens) for b in batches]

    def transcribe_files(
        self, paths: Sequence[str], omit_special_tokens: bool = True
    ) -> List[TranscriptionResult]:
        """Batch file transcription: N files → one padded [N, 480000] host
        batch → one run. The files are read by the native loader when it is
        built (``native/``; plain WAVs without ``reference_quirks``), else
        by the Python readers, to the same samples. On a mesh of several
        processes each data rank reads only its share of ``paths``
        (``parallel/multihost.py``), and every rank returns the full,
        path-ordered result list."""
        if self.mesh is not None and world_size() > 1:
            return self._transcribe_files_multiprocess(paths, omit_special_tokens)
        batch = read_files(paths, N_SAMPLES, self._read_audio, self._native_reads(paths))
        return self.transcribe_batch(batch, omit_special_tokens)

    def _native_reads(self, paths: Sequence[str]) -> bool:
        """Whether the native loader reads ``paths`` as :meth:`_read_audio`
        does: WAVs only (no raw PCM) and without the reference's stereo
        quirk, which its batch loader does not take."""
        return not self.config.reference_quirks and not any(
            p.endswith((".pcm", ".raw")) for p in paths
        )

    def _transcribe_files_multiprocess(
        self, paths: Sequence[str], omit_special_tokens: bool
    ) -> List[TranscriptionResult]:
        """``transcribe_files`` over several processes, with the whole
        fallback ladder: every rank gathers the same rows, computes the same
        failing set from the same gates, and the failing *paths* run again
        as one pass of their own (each rank reads only its share of them),
        so every rank stays in step and no audio moves between ranks. Word
        timestamps are not computed on this path, as in JAX."""
        primary_t = self._schedule[0] if self._sampling_primary else None
        rows, mel_ms, model_ms = self._mp_pass(
            paths, temperature=primary_t,
            generator=None if primary_t is None else self._generator(0),
        )
        temps = [self._schedule[0]] * len(paths)

        def failing(idxs):
            toks, lens, lps, _ = zip(*rows)
            return self._failing(toks, lens, lps, idxs)

        pending = failing(range(len(paths)))
        for attempt, temp in enumerate(self._schedule[1:], start=1):
            if not pending:
                break
            r_rows, _, r_ms = self._mp_pass(
                [paths[i] for i in pending], temperature=temp, generator=self._generator(attempt)
            )
            model_ms += r_ms
            for j, i in enumerate(pending):  # the last attempt is kept
                rows[i] = r_rows[j]
                temps[i] = temp
            pending = failing(pending)
        return [
            self.result_from_tokens(
                toks, length, omit_special_tokens, mel_ms=mel_ms, model_ms=model_ms,
                avg_logprob=lp, no_speech_prob=nsp,
                temperature=float(temps[i]) if self._sampling_on else None,
            )
            for i, (toks, length, lp, nsp) in enumerate(rows)
        ]

    def _mp_pass(
        self,
        path_list: Sequence[str],
        temperature: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One pass over ``path_list`` on every rank: each rank reads its
        files into the uniform row count, runs them (at ``temperature``
        through the sampler, when given), and the gathered rows are mapped
        back to path order. Returns (per-path [(tokens, length,
        avg_logprob, no_speech_prob)], mel_ms, model_ms).

        The gathered rows are data-rank-major, every data rank padded to the
        same ``uniform_host_rows`` count (the ranks of a model group read the
        same files); the row → path mapping is rebuilt from the same shard
        function, so every rank computes the same rows. The
        rows ship as float32 and "auto" crops to the full window, as on
        JAX's multi-process path."""
        rows, _ = load_files_sharded(
            path_list, self.mesh, max_len=N_SAMPLES, read=self._read_audio,
            native=self._native_reads(path_list),
        )
        tokens, lengths, avg_lp, nsp, mel_ms, model_ms, _ = self._run(
            rows, self._resolve_audio_ctx(None), temperature=temperature, generator=generator
        )
        per_host = uniform_host_rows(len(path_list), self.mesh)
        out: List[Optional[tuple]] = [None] * len(path_list)
        pc = data_processes(self.mesh)[1]
        for p in range(pc):
            s, e = host_shard(len(path_list), p, pc)
            row = p * per_host
            for i in range(e - s):
                out[s + i] = (
                    np.asarray(tokens[row + i]),
                    int(lengths[row + i]),
                    None if avg_lp is None else float(avg_lp[row + i]),
                    None if nsp is None else float(nsp[row + i]),
                )
        return out, mel_ms, model_ms

    def result_from_tokens(
        self,
        tokens: np.ndarray,  # [total_len] int32, prompt included
        length: int,
        omit_special_tokens: bool = True,
        mel_ms: Optional[float] = None,
        model_ms: float = 0.0,
        no_speech_prob: Optional[float] = None,
        avg_logprob: Optional[float] = None,
        temperature: Optional[float] = None,
        words: Optional[list] = None,
    ) -> TranscriptionResult:
        """Detokenize one decoded row into a TranscriptionResult."""
        row = np.asarray(tokens[:length])
        # With an initial-prompt prefix, ordinary text tokens precede SOT;
        # the transcript starts at SOT.
        text_row = row[self._sot_index :] if omit_special_tokens else row
        text = decode_tokens(self.vocab, text_row, omit_special_tokens)
        if self.config.multilingual and len(row) > self._sot_index + 1:
            language = lang_token_to_code(
                row[self._sot_index + 1], self.vocab.specials.sot
            )
        else:
            language = "en" if not self.config.multilingual else ""
        segments = parse_segments(self.vocab, row) if self.config.timestamps else None
        cr = compression_ratio(text) if self._sampling_on else None
        # Silence gate (openai transcribe.py): skip the window when the
        # no-speech probability clears the threshold, unless a high
        # avg_logprob (beam) overrides it.
        thr = self.config.no_speech_threshold
        is_silent = thr is not None and no_speech_prob is not None and no_speech_prob > thr
        lp_thr = self.config.logprob_threshold
        if is_silent and lp_thr is not None and avg_logprob is not None and avg_logprob > lp_thr:
            is_silent = False
        return TranscriptionResult(
            text="" if is_silent else text,
            tokens=np.asarray(tokens),
            length=length,
            language=language,
            segments=segments,
            mel_ms=mel_ms,
            model_ms=model_ms,
            no_speech_prob=no_speech_prob,
            is_silent=is_silent,
            avg_logprob=avg_logprob,
            compression_ratio=cr,
            temperature=temperature,
            words=words,
        )

    # --- long form -----------------------------------------------------------
    def transcribe_long(
        self, audio: Union[str, np.ndarray], omit_special_tokens: bool = True
    ) -> LongTranscriptionResult:
        """Audio of any length: VAD speech spans (``audio/vad.speech_segments``)
        packed into ≤ 30 s chunks, a span longer than 30 s split hard, and
        every chunk transcribed in one batch. No conditioning across
        chunks (see :meth:`transcribe_sequential` for that)."""
        samples = (
            self._read_audio(audio) if isinstance(audio, str)
            else np.asarray(audio, dtype=np.float32)
        )
        chunks: List[Tuple[int, np.ndarray]] = []  # (start_sample, chunk)
        if len(samples) <= N_SAMPLES:
            chunks.append((0, samples))
        else:
            spans = speech_segments(samples) or [(0, len(samples))]
            win_start, win_end = None, None
            for s, e in spans:
                while e - s > N_SAMPLES:  # one long span → hard split
                    if win_start is not None:
                        chunks.append((win_start, samples[win_start:win_end]))
                        win_start = None
                    chunks.append((s, samples[s : s + N_SAMPLES]))
                    s += N_SAMPLES
                if win_start is None:
                    win_start, win_end = s, e
                elif e - win_start <= N_SAMPLES:
                    win_end = e
                else:
                    chunks.append((win_start, samples[win_start:win_end]))
                    win_start, win_end = s, e
            if win_start is not None:
                chunks.append((win_start, samples[win_start:win_end]))

        max_len = max(len(c) for _, c in chunks)
        batch = np.zeros((len(chunks), min(max_len, N_SAMPLES)), np.float32)
        for i, (_, c) in enumerate(chunks):
            n = min(len(c), N_SAMPLES)
            batch[i, :n] = c[:n]
        results = self.transcribe_batch(batch, omit_special_tokens)
        text = " ".join(r.clean_text().strip() for r in results if r.clean_text().strip())
        return LongTranscriptionResult(
            text=text, offsets=[s / 16_000.0 for s, _ in chunks], chunks=results
        )

    def transcribe_sequential(
        self, audio: Union[str, np.ndarray], condition_on_previous_text: bool = True
    ) -> TranscriptionResult:
        """openai-style sequential long form: a sliding 30 s window with
        timestamp-driven seek and previous-text conditioning
        (``decode/sequential.py``). One result whose ``segments`` carry
        absolute times over the whole file, and whose ``tokens`` are the
        segments' text tokens.

        Timestamp rules are on whatever ``config.timestamps`` says; every
        window is encoded whole (no ``audio_ctx`` crop), sent as float32,
        and decoded greedy or by beam with a budget of ``min(max_new_tokens,
        n_text_ctx - P)``; no fallback ladder, no silence gate. The language
        is detected once, on the first window, when not configured. Not on
        a mesh: the windows run one after the other on one rank."""
        if self.mesh is not None:
            raise ValueError("transcribe_sequential runs one window at a time, not on a mesh")
        samples = (
            self._read_audio(audio) if isinstance(audio, str)
            else np.asarray(audio, dtype=np.float32)
        )
        st = self.vocab.specials
        language = self.config.language
        if language is None and self.config.multilingual:
            language = self._detect_language_once(samples[:N_SAMPLES])
        rules = make_rules(
            self.vocab, timestamps=True, suppress_blank=self.config.suppress_blank,
            suppress_nonspeech=self.config.suppress_nonspeech, n_vocab=self.dims.n_vocab,
        )

        t_run = time.perf_counter()
        seek = 0  # samples
        prev_tokens: List[int] = []
        all_segments: list = []
        all_text_tokens: List[int] = []
        model_ms = 0.0
        n_total = max(len(samples), 1)
        while seek < n_total:
            window = np.zeros((1, N_SAMPLES), np.float32)
            chunk = samples[seek : seek + N_SAMPLES]
            window[0, : len(chunk)] = chunk
            prefix = crop_prefix(prev_tokens) if condition_on_previous_text else []
            prompt = build_prompt(
                self.config.multilingual,
                language=language,
                task=self.config.task,
                timestamps=True,
                specials=st,
                reference_quirks=self.config.reference_quirks,
                prefix_tokens=prefix or None,
                n_text_ctx=self.dims.n_text_ctx,
            )
            t0 = time.perf_counter()
            tokens, length = self._seq_window(window, prompt, rules)
            model_ms += (time.perf_counter() - t0) * 1e3

            gen = [int(t) for t in tokens[len(prompt) : length]]
            emit, advance_s = window_emit_and_advance(gen, st.beg, st.eot)
            segs = parse_segments(self.vocab, emit, time_offset=seek / 16_000.0)
            all_segments.extend(segs)
            for seg in segs:
                all_text_tokens.extend(seg.tokens)
                prev_tokens.extend(seg.tokens)
            seek += int(advance_s * 16_000)

        text = decode_tokens(self.vocab, all_text_tokens, True)
        self.timer.record("model", model_ms / 1e3)
        self.throughput.add(
            audio_seconds=len(samples) / 16_000.0,
            tokens=len(all_text_tokens),
            utterances=1,
            wall_s=time.perf_counter() - t_run,
        )
        return TranscriptionResult(
            text=text,
            tokens=np.asarray(all_text_tokens, np.int32),
            length=len(all_text_tokens),
            language=language or "",
            segments=all_segments,
            mel_ms=None,
            model_ms=model_ms,
        )

    def _seq_window(self, window: np.ndarray, prompt: List[int], rules) -> Tuple[np.ndarray, int]:
        """One sequential window: mel → encoder → timestamp-rule decode with
        ``prompt`` → (token row on the host, its length)."""
        enc_out = self._encode(window, None)
        budget = self.dims.n_text_ctx - len(prompt)
        max_new = (
            min(self.config.max_new_tokens, budget)
            if self.config.max_new_tokens is not None
            else budget
        )
        prompts = torch.tensor([prompt], dtype=torch.long, device=self.device)
        common = dict(
            dims=self.dims, eot=self.vocab.specials.eot, max_new_tokens=max_new, rules=rules,
            logit_bias=self._logit_bias, compute_dtype=self._compute_dtype,
            kv_cache_dtype=self._kv_dtype,
        )
        if self.config.beam_size > 1:
            out = beam_decode(
                self.assets.params, enc_out, prompts, beam_size=self.config.beam_size,
                fused=self.config.fused_step, **common,
            )
        else:
            out = greedy_decode(self.assets.params, enc_out, prompts, **common)
        return out[0][0].int().cpu().numpy(), int(out[1][0])

    def _detect_language_once(self, samples: np.ndarray) -> str:
        """One-shot language ID on the first window (the sequential mode
        pins the language for the whole file, as openai transcribe does)."""
        window = np.zeros((1, N_SAMPLES), np.float32)
        window[0, : len(samples)] = samples[:N_SAMPLES]
        tok = detect_language_tokens(
            self.assets.params, self._encode(window, None), self.dims,
            sot=self.vocab.specials.sot, compute_dtype=self._compute_dtype,
        )
        return lang_code(int(tok[0]) - self.vocab.specials.sot - 1)

    # --- constructors ------------------------------------------------------
    @classmethod
    def from_random(
        cls,
        config: EngineConfig,
        seed: int = 0,
        vocab: Optional[Vocab] = None,
        device: Union[str, torch.device] = "cuda",
        draft_params: Optional[Params] = None,
    ) -> "Engine":
        """Random-weights engine for tests and benchmarks, drawn on
        ``device`` from a generator seeded with ``seed``. The numbers differ
        from the JAX package's ``from_random`` (another PRNG). A
        ``draft_model`` without ``draft_params`` is random too (seed 1)."""
        device = resolve_device(device)
        if int(np.prod(config.mesh_shape)) > 1:
            device = rank_device(device)  # every rank draws the same weights on its card
        dims = config.dims()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(dims, gen, dtype=getattr(torch, config.dtype), device=device)
        return cls.from_assets(params, config, vocab=vocab, device=device, draft_params=draft_params)

    @classmethod
    def from_assets(
        cls,
        params: Params,
        config: EngineConfig,
        vocab_bin: Optional[str] = None,
        vocab: Optional[Vocab] = None,
        device: Union[str, torch.device] = "cuda",
        draft_params: Optional[Params] = None,
        shard: Optional[Tuple[int, int]] = None,
    ) -> "Engine":
        """Engine over given port parameters (see
        ``models.params.params_from_jax`` for weights from the JAX package);
        ``draft_params`` likewise for ``config.draft_model``. ``shard``:
        ``params`` is the slice (model index, model size) of a
        tensor-parallel rank (``utils/checkpoint.load_params`` with a
        mesh), which must be this engine's rank."""
        dims = config.dims()
        if vocab_bin is not None:
            assets_bin = read_bin(vocab_bin, multilingual=config.multilingual)
            vocab = assets_bin.vocab
            filters = assets_bin.mel_filters
        else:
            vocab = vocab or Vocab.synthetic(
                multilingual=config.multilingual,
                num_languages=num_languages_for(dims.n_vocab),
            )
            filters = mel_filterbank(n_mels=dims.n_mels)
        return cls(
            _Assets(params, dims, vocab, filters, shard), config, device=device,
            draft_params=draft_params,
        )


class Monolith(Engine):
    """The whole pipeline as one run (reference whisper.cpp:667-738): pad →
    mel → encode → decode → token IDs."""

    def _run(self, batch, audio_ctx, temperature=None, generator=None):
        t0 = time.perf_counter()
        samples = self._place_batch(batch)
        enc_out = self._encoder_output(samples, audio_ctx)
        draft_enc = None
        if self._draft_params is not None and not self._draft_share_encoder:
            # A draft of another frontend geometry (e.g. tiny's 80 mel bins
            # under large-v3's 128): its own mel and encoder on the same
            # samples, the same crop.
            draft_enc = self._encoder_output(samples, audio_ctx, draft=True)
        out = self._to_host(self._decode(enc_out, temperature, generator, draft_enc=draft_enc))
        return (*out, None, (time.perf_counter() - t0) * 1e3, enc_out)

    def transcribe_batches(
        self, batches: Sequence[np.ndarray], omit_special_tokens: bool = True
    ) -> List[List[TranscriptionResult]]:
        """Double-buffered batch stream (JAX's ``Monolith.transcribe_batches``):
        batch i+1's host→device copy and its encode (mel, encoder, a draft's
        own encoder, the prompts with language detection and the cross-KV)
        are enqueued before batch i's decode starts, and batch i's results
        are built on the host after batch i+2's encode is enqueued, while
        the card works. Token-identical to a loop of ``transcribe_batch``;
        one result list per batch. Each batch records its ``model`` time
        and throughput from its dispatch to its fetch.

        On the card the copy and the encode run on two side streams of
        :class:`_BatchStream` (pinned staging buffers, events between the
        streams) and the decode on the caller's current stream. On the
        CPU the same calls run in the same order, without streams.

        Paths that need a batch's results on the host before the next one
        (a sampling primary, the fallback ladder, word timestamps, a mesh of
        several processes) take the sequential base, as in JAX."""
        if (
            self._sampling_primary
            or len(self._schedule) > 1
            or self._align_mask is not None
            or (self.mesh is not None and world_size() > 1)
        ):
            return super().transcribe_batches(batches, omit_special_tokens)
        stream = _BatchStream(self.device)
        out: List[List[TranscriptionResult]] = []
        fetched = None  # the batch decoded last: its results are built next
        nxt = self._stream_encode(stream, self._stream_stage(stream, batches[0])) if batches else None
        for i in range(len(batches)):
            cur = nxt
            if i + 1 < len(batches):
                nxt = self._stream_encode(stream, self._stream_stage(stream, batches[i + 1]))
            if fetched is not None:
                out.append(self._stream_results(fetched, omit_special_tokens))
            fetched = self._stream_decode(stream, cur)
        if fetched is not None:
            out.append(self._stream_results(fetched, omit_special_tokens))
        return out

    def _stream_stage(self, stream: "_BatchStream", samples: np.ndarray) -> dict:
        """One batch on the host (pad, bucket, its "auto" crop) and its copy
        to the device on the copy stream. Its dispatch time starts here, and
        its root span (``engine.batch``, recorded by :meth:`_stream_results`):
        each step of the batch runs in the root's :func:`scope`."""
        trace = (next_number(), next_span_id())
        start_ns = time.time_ns()
        with scope(*trace), annotate("engine.prepare"):
            batch, b, n = self._prepare_batch(np.asarray(samples, dtype=np.float32))
            ac = self._resolve_audio_ctx(batch)
        t0 = time.perf_counter()
        x, copied = stream.stage(batch)
        return dict(b=b, n=n, audio_ctx=ac, t0=t0, samples=x, copied=copied, trace=trace,
                    start_ns=start_ns, padded=batch.shape[0])

    def _stream_encode(self, stream: "_BatchStream", job: dict) -> dict:
        """Enqueue one staged batch's encode on the encode stream: its
        samples to f32, log-mel and encoder (and a draft's own), the prompts
        with language detection and the cross-KV. Makes no host sync."""
        with scope(*job["trace"]), stream.on(stream.encode):
            stream.wait(stream.encode, job.pop("copied"))
            samples = job.pop("samples")
            stream.hand_over(samples, stream.encode)
            x = _samples_f32(samples)
            enc_out = self._encoder_output(x, job["audio_ctx"])
            draft_enc = None
            if self._draft_params is not None and not self._draft_share_encoder:
                draft_enc = self._encoder_output(x, job["audio_ctx"], draft=True)
            prompts, cross_kv = self._make_prompts(self.assets.params, enc_out)
            job["encoded"] = stream.event(stream.encode)
        # The decode stream reads these: the allocator must not hand their
        # memory to a later encode while that decode may still run.
        stream.hand_over((enc_out, draft_enc, prompts, cross_kv), stream.decode)
        job.update(enc_out=enc_out, draft_enc=draft_enc, prompts=prompts, cross_kv=cross_kv)
        return job

    def _stream_decode(self, stream: "_BatchStream", job: dict) -> dict:
        """Decode one encoded batch on the current stream, behind its encode
        event, and start its outputs' copy to the host behind an event."""
        stream.wait(stream.decode, job.pop("encoded"))
        steps0 = decode_steps()
        with scope(*job["trace"]):
            outs = self._decode(
                job.pop("enc_out"), draft_enc=job.pop("draft_enc"),
                prompts=(job.pop("prompts"), job.pop("cross_kv")),
            )
        job["steps"] = decode_steps() - steps0
        job["host"], job["fetched"] = stream.to_host(outs)
        return job

    def _stream_results(self, job: dict, omit_special_tokens: bool) -> List[TranscriptionResult]:
        """Wait for one batch's outputs on the host, record its time and
        throughput, and build its results."""
        if job["fetched"] is not None:
            job["fetched"].synchronize()
        with scope(*job["trace"]), annotate("engine.results"):
            tokens, lengths, avg_lp, nsp = (
                None if x is None else x.numpy() for x in job["host"]
            )
            b, n = job["b"], job["n"]
            dt = (time.perf_counter() - job["t0"]) * 1e3
            self.timer.record("model", dt / 1e3)
            self.throughput.add(
                audio_seconds=b * (n / 16_000.0),
                tokens=int(np.sum(lengths[:b])),
                utterances=b,
                wall_s=dt / 1e3,
            )
            results = [
                self.result_from_tokens(
                    tokens[i], int(lengths[i]), omit_special_tokens, model_ms=dt,
                    avg_logprob=None if avg_lp is None else float(avg_lp[i]),
                    no_speech_prob=None if nsp is None else float(nsp[i]),
                )
                for i in range(b)
            ]
        number, root = job["trace"]
        ac = job["audio_ctx"]
        record("engine.batch", job["start_ns"], time.time_ns(), trace_id=number, span_id=root,
               rows=b, padded_rows=job["padded"],
               audio_ctx=self.dims.n_audio_ctx if ac is None else ac,
               steps=job["steps"], encoder_rows=job["padded"])
        return results


class _BatchStream:
    """The streams, staging buffers and events of one
    :meth:`Monolith.transcribe_batches` call. On the card: a copy stream
    and an encode stream beside the caller's current stream (the decode's),
    two pinned host buffers that take turns (one is refilled only after
    its last copy has completed), and events between the streams. On the
    CPU every method runs its work in place and returns no event."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy = self.encode = self.decode = None
        if self.cuda:
            self.copy = torch.cuda.Stream(device)
            self.encode = torch.cuda.Stream(device)
            self.decode = torch.cuda.current_stream(device)
        self._buffers = [(None, None), (None, None)]  # (pinned buffer, its last copy's event)
        self._turn = 0

    def on(self, stream):
        return torch.cuda.stream(stream) if self.cuda else contextlib.nullcontext()

    def event(self, stream):
        """An event recorded on ``stream`` now (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def wait(self, stream, event) -> None:
        """``stream`` waits for ``event`` on the card, not on the host."""
        if event is not None:
            stream.wait_event(event)

    def hand_over(self, tensors, stream) -> None:
        """Mark every tensor of ``tensors`` (nested tuples, lists, dicts) as
        used on ``stream``, so that its memory is not reused before the work
        queued there when it is freed has run (``Tensor.record_stream``)."""
        if not self.cuda or tensors is None:
            return
        if isinstance(tensors, torch.Tensor):
            tensors.record_stream(stream)
        elif isinstance(tensors, dict):
            for t in tensors.values():
                self.hand_over(t, stream)
        else:
            for t in tensors:
                self.hand_over(t, stream)

    def stage(self, batch: np.ndarray):
        """Host batch → (device tensor, the event after its copy): into the
        next pinned buffer, then a non-blocking copy on the copy stream."""
        if not self.cuda:
            return torch.from_numpy(batch), None
        turn, self._turn = self._turn, 1 - self._turn
        buf, last = self._buffers[turn]
        if last is not None:
            last.synchronize()  # the buffer's last copy has left it
        src = torch.from_numpy(batch)
        if buf is None or buf.dtype != src.dtype or buf.numel() < src.numel():
            buf = torch.empty(src.numel(), dtype=src.dtype, pin_memory=True)
        host = buf[: src.numel()].view(src.shape)
        host.copy_(src)
        with torch.cuda.stream(self.copy):
            x = host.to(self.device, non_blocking=True)
            copied = self.event(self.copy)
        self._buffers[turn] = (buf, copied)
        return x, copied

    def to_host(self, outs):
        """Device outputs → host tensors (token ids and lengths as int32)
        and the event after which they are there: non-blocking copies into
        pinned memory on the current stream."""
        host = [
            None if x is None
            else (x.int() if not x.is_floating_point() else x).to("cpu", non_blocking=self.cuda)
            for x in outs
        ]
        return host, self.event(self.decode)


class EncDec(Engine):
    """Separate encode and decode stages (reference whisper.cpp:740-776)."""

    def __init__(self, assets: _Assets, config: EngineConfig, **kw):
        super().__init__(assets, config, **kw)
        if self._draft_params is not None and not self._draft_share_encoder:
            raise ValueError(
                "EncDec with a draft of different frontend geometry is "
                "unsupported (the decode stage has no samples to run the "
                "draft encoder on); use MONOLITH, or a Distil draft that "
                "shares the target's encoder geometry"
            )

    def _run(self, batch, audio_ctx, temperature=None, generator=None):
        t0 = time.perf_counter()
        enc_out = self._encode(batch, audio_ctx)
        self._sync()
        t1 = time.perf_counter()
        out = self._to_host(self._decode(enc_out, temperature, generator))
        t2 = time.perf_counter()
        return (*out, (t1 - t0) * 1e3, (t2 - t1) * 1e3, enc_out)


def create_engine(
    engine_type: Union[EngineType, int],
    config: EngineConfig,
    params: Optional[Params] = None,
    vocab_bin: Optional[str] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    draft_params: Optional[Params] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Engine:
    """Factory (reference create_engine, whisper.cpp:778-790). ``params``
    None → random weights from ``seed``. ``draft_params``: weights for
    ``config.draft_model`` (None: a random draft; the output is the
    target's greedy decode all the same, see ``decode/speculative.py``).
    ``shard``: ``params`` is a tensor-parallel rank's slice (see
    :meth:`Engine.from_assets`)."""
    cls = Monolith if EngineType(engine_type) == EngineType.MONOLITH else EncDec
    if params is None:
        return cls.from_random(config, seed=seed, device=device, draft_params=draft_params)
    return cls.from_assets(
        params, config, vocab_bin=vocab_bin, device=device, draft_params=draft_params,
        shard=shard,
    )
