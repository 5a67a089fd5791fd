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

``mesh_shape=(d, 1)`` runs the engine as one rank of a data-parallel
world of d processes (``parallel/``, over gloo): each rank encodes and
decodes its contiguous share of the batch (beam "hybrid" through K2′), and
every rank returns the full, ordered result list. ``transcribe_files``
reads on each rank only that rank's files.

Entry points take ``device=`` and default to ``"cuda"``: asking for CUDA
where there is none raises, and the CPU runs only when asked for. Config
options outside this slice raise ``NotImplementedError`` at construction.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from whisper_tpu_torch.audio.wav import read_pcm_f32, read_wav, read_wav_legacy
from whisper_tpu_torch.config import N_SAMPLES, EngineConfig, ModelDims
from whisper_tpu_torch.decode.beam import beam_decode
from whisper_tpu_torch.decode.greedy import greedy_decode
from whisper_tpu_torch.decode.language import detect_language_tokens, lang_token_to_code
from whisper_tpu_torch.decode.logits import make_rules
from whisper_tpu_torch.decode.prompt import build_prompt
from whisper_tpu_torch.decode.segments import parse_segments
from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.frontend.mel import log_mel_spectrogram
from whisper_tpu_torch.models.decoder import precompute_cross_kv
from whisper_tpu_torch.models.encoder import encode
from whisper_tpu_torch.models.params import Params, init_params, to_device
from whisper_tpu_torch.models.quantize import is_quantized, quantize_params
from whisper_tpu_torch.parallel.mesh import make_mesh, rank_device
from whisper_tpu_torch.parallel.multihost import (
    allgather_rows,
    host_shard,
    load_files_sharded,
    uniform_host_rows,
    world_size,
)
from whisper_tpu_torch.tokenizer.binfmt import read_bin
from whisper_tpu_torch.tokenizer.detokenize import decode_tokens, remove_extra_spaces
from whisper_tpu_torch.tokenizer.vocab import Vocab, num_languages_for
from whisper_tpu_torch.utils.profiling import StageTimer, Throughput


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
    avg_logprob: Optional[float] = None  # beam: the length-normalised score

    def clean_text(self) -> str:
        return remove_extra_spaces(self.text)


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


def _unsupported(config: EngineConfig) -> List[str]:
    """Config options outside the ported slice, by name."""
    out = []
    if config.temperature != 0 or config.fallback_temperatures:
        out.append("temperature sampling / fallback_temperatures")
    if config.word_timestamps:
        out.append("word_timestamps=True")
    if config.draft_model is not None:
        out.append("draft_model (speculative decoding)")
    if int(np.prod(config.mesh_shape[1:])) > 1:
        out.append(f"tensor parallelism: mesh_shape={tuple(config.mesh_shape)} (model axis > 1)")
    if config.initial_prompt is not None:
        out.append("initial_prompt text (BPE encoder)")
    return out


@dataclasses.dataclass
class _Assets:
    params: Params
    dims: ModelDims
    vocab: Vocab
    mel_filters: np.ndarray


class Engine:
    """Abstract engine (whisper.h:159-163): transcribe float samples or a
    wave file, one utterance or a batch."""

    def __init__(
        self,
        assets: _Assets,
        config: EngineConfig,
        device: Union[str, torch.device] = "cuda",
    ):
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError(
                "not ported to whisper_tpu_torch yet: " + ", ".join(missing)
            )
        if config.quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization: {config.quantization!r}")
        self.device = resolve_device(device)
        # A data-parallel mesh: this process is one rank of it, on its device.
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
        params = to_device(assets.params, self.device)
        if config.quantization == "int8" and not is_quantized(params):
            params = quantize_params(params)
        assets = dataclasses.replace(assets, params=params)
        self.assets = assets
        # language=None on a multilingual model → per-utterance detection.
        self._autodetect = config.language is None and config.multilingual
        prompt = build_prompt(
            multilingual=config.multilingual,
            language=config.language or "en",
            task=config.task,
            timestamps=config.timestamps,
            specials=assets.vocab.specials,
            reference_quirks=config.reference_quirks,
            prefix_tokens=(
                list(config.initial_prompt_tokens)
                if config.initial_prompt_tokens
                else None
            ),
            n_text_ctx=self.dims.n_text_ctx,
        )
        self._prompt = np.asarray(prompt, dtype=np.int32)
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
        # Stage times and throughput counters (utils/profiling.py), recorded
        # by transcribe_batch and read by the HTTP server's /metrics.
        self.timer = StageTimer()
        self.throughput = Throughput()

    # --- stages ------------------------------------------------------------
    def _encode(self, batch: np.ndarray, audio_ctx: Optional[int]) -> torch.Tensor:
        """Host rows → encoder output on the device, cropped to
        ``audio_ctx`` positions (None: the full window; see
        :meth:`_resolve_audio_ctx`)."""
        samples = self._place_batch(batch)
        mel = log_mel_spectrogram(
            samples, self._filters, n_mels=self.dims.n_mels, compute_dtype=torch.float32
        )
        enc_out = encode(self.assets.params, mel.to(self._compute_dtype), self.dims)
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
        prompts = torch.from_numpy(self._prompt).to(enc_out.device, torch.long)
        prompts = prompts[None, :].repeat(b, 1)
        if not self._autodetect:
            return prompts, None
        cross_kv = precompute_cross_kv(
            params, enc_out, self.dims, kv_dtype=self._kv_dtype
        )
        lang_toks = detect_language_tokens(
            params,
            enc_out,
            self.dims,
            sot=self.vocab.specials.sot,
            compute_dtype=self._compute_dtype,
            cross_kv=cross_kv,
        )
        prompts[:, self._sot_index + 1] = lang_toks
        return prompts, cross_kv

    def _decode(self, enc_out: torch.Tensor):
        """Greedy or beam decode → (tokens, lengths, avg_logprob or None,
        no_speech probs or None). Beam rows report their length-normalised
        score as avg_logprob."""
        prompts, cross_kv = self._make_prompts(self.assets.params, enc_out)
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
        if self.config.beam_size > 1:
            out = beam_decode(
                self.assets.params, enc_out, prompts, beam_size=self.config.beam_size,
                fused=self.config.fused_step, mesh=self.mesh, **common,
            )
            return out[0], out[1], out[2], out[3] if ns else None
        out = greedy_decode(self.assets.params, enc_out, prompts, **common)
        return out[0], out[1], None, out[2] if ns else None

    def _run(self, batch: np.ndarray, audio_ctx: Optional[int]):
        """One device run of this rank's rows → (tokens, lengths,
        avg_logprob or None, no_speech probs or None) of every rank's rows
        on the host (:meth:`_to_host`), plus (mel_ms, model_ms)."""
        raise NotImplementedError

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_host(self, outs) -> list:
        """Device → host, across the ranks on a mesh: every rank ends up with
        every rank's rows, in rank order. Token ids and lengths come back as
        int32, as in JAX."""
        host = [
            None if x is None else (x.int() if not x.is_floating_point() else x).cpu().numpy()
            for x in outs
        ]
        if self.mesh is None:
            return host
        return [None if x is None else allgather_rows(x) for x in host]

    # --- host side ---------------------------------------------------------
    def _prepare_batch(self, samples: np.ndarray):
        """Pad/truncate to the 30 s window and bucket the batch axis.
        Returns (host batch [padded_b, N_SAMPLES], true rows b, valid
        samples n)."""
        b = samples.shape[0]
        padded_b = batch_bucket(b)
        if self.mesh is not None:  # whole, equal shares per rank
            d = self.mesh.data_size
            padded_b = -(-padded_b // d) * d
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
        x = torch.from_numpy(batch).to(self.device)
        if x.dtype == torch.int16:
            x = x.float() * (1.0 / 32768.0)
        return x

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
        and returns every row's result."""
        batch, b, n = self._prepare_batch(np.asarray(samples, dtype=np.float32))
        ac = self._resolve_audio_ctx(batch)
        rows = batch if self.mesh is None else self.mesh.local_rows(batch)
        tokens, lengths, avg_lp, nsp, mel_ms, model_ms = self._run(rows, ac)
        if mel_ms:
            self.timer.record("mel", mel_ms / 1e3)
        self.timer.record("model", model_ms / 1e3)
        self.throughput.add(
            audio_seconds=b * (n / 16_000.0),
            tokens=int(np.sum(lengths[:b])),
            utterances=b,
            wall_s=((mel_ms or 0.0) + model_ms) / 1e3,
        )
        return [
            self.result_from_tokens(
                tokens[i], int(lengths[i]), omit_special_tokens,
                mel_ms=mel_ms, model_ms=model_ms,
                no_speech_prob=None if nsp is None else float(nsp[i]),
                avg_logprob=None if avg_lp is None else float(avg_lp[i]),
            )
            for i in range(b)
        ]

    def transcribe_batches(
        self, batches: Sequence[np.ndarray], omit_special_tokens: bool = True
    ) -> List[List[TranscriptionResult]]:
        """Transcribe a sequence of batches, one after the other."""
        return [self.transcribe_batch(b, omit_special_tokens) for b in batches]

    def transcribe_files(
        self, paths: Sequence[str], omit_special_tokens: bool = True
    ) -> List[TranscriptionResult]:
        """Batch file transcription: N files → one padded [N, 480000] host
        batch → one run. On a mesh of several processes each rank reads
        only its share of ``paths`` (``parallel/multihost.py``), and every
        rank returns the full, path-ordered result list."""
        if self.mesh is not None and world_size() > 1:
            # JAX's temperature-fallback ladder is not carried over: sampling
            # is not ported (the engine refuses it).
            rows, mel_ms, model_ms = self._mp_pass(paths)
            return [
                self.result_from_tokens(
                    toks, length, omit_special_tokens, mel_ms=mel_ms, model_ms=model_ms,
                    avg_logprob=lp, no_speech_prob=nsp,
                )
                for toks, length, lp, nsp in rows
            ]
        batch = np.zeros((len(paths), N_SAMPLES), dtype=np.float32)
        for i, p in enumerate(paths):
            s = self._read_audio(p)
            n = min(len(s), N_SAMPLES)
            batch[i, :n] = s[:n]
        return self.transcribe_batch(batch, omit_special_tokens)

    def _mp_pass(self, path_list: Sequence[str]):
        """One pass over ``path_list`` on every rank: each rank reads its
        files into the uniform row count, runs them, and the gathered rows
        are mapped back to path order. Returns (per-path [(tokens, length,
        avg_logprob, no_speech_prob)], mel_ms, model_ms).

        The gathered rows are rank-major, every rank padded to the same
        ``uniform_host_rows`` count; the row → path mapping is rebuilt from
        the same shard function, so every rank computes the same rows. The
        rows ship as float32 and "auto" crops to the full window, as on
        JAX's multi-process path."""
        rows, _ = load_files_sharded(
            path_list, self.mesh, max_len=N_SAMPLES, read=self._read_audio
        )
        tokens, lengths, avg_lp, nsp, mel_ms, model_ms = self._run(
            rows, self._resolve_audio_ctx(None)
        )
        per_host = uniform_host_rows(len(path_list), self.mesh)
        out: List[Optional[tuple]] = [None] * len(path_list)
        pc = world_size()
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
        )

    # --- constructors ------------------------------------------------------
    @classmethod
    def from_random(
        cls,
        config: EngineConfig,
        seed: int = 0,
        vocab: Optional[Vocab] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Engine":
        """Random-weights engine for tests and benchmarks, drawn on
        ``device`` from a generator seeded with ``seed``. The numbers differ
        from the JAX package's ``from_random`` (another PRNG)."""
        device = resolve_device(device)
        if int(np.prod(config.mesh_shape)) > 1:
            device = rank_device(device)  # every rank draws the same weights on its card
        dims = config.dims()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(dims, gen, dtype=getattr(torch, config.dtype), device=device)
        return cls.from_assets(params, config, vocab=vocab, device=device)

    @classmethod
    def from_assets(
        cls,
        params: Params,
        config: EngineConfig,
        vocab_bin: Optional[str] = None,
        vocab: Optional[Vocab] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Engine":
        """Engine over given port parameters (see
        ``models.params.params_from_jax`` for weights from the JAX package)."""
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
        return cls(_Assets(params, dims, vocab, filters), config, device=device)


class Monolith(Engine):
    """The whole pipeline as one run (reference whisper.cpp:667-738): pad →
    mel → encode → decode → token IDs."""

    def _run(self, batch: np.ndarray, audio_ctx: Optional[int]):
        t0 = time.perf_counter()
        out = self._to_host(self._decode(self._encode(batch, audio_ctx)))
        return (*out, None, (time.perf_counter() - t0) * 1e3)


class EncDec(Engine):
    """Separate encode and decode stages (reference whisper.cpp:740-776)."""

    def _run(self, batch: np.ndarray, audio_ctx: Optional[int]):
        t0 = time.perf_counter()
        enc_out = self._encode(batch, audio_ctx)
        self._sync()
        t1 = time.perf_counter()
        out = self._to_host(self._decode(enc_out))
        t2 = time.perf_counter()
        return (*out, (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def create_engine(
    engine_type: Union[EngineType, int],
    config: EngineConfig,
    params: Optional[Params] = None,
    vocab_bin: Optional[str] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Engine:
    """Factory (reference create_engine, whisper.cpp:778-790). ``params``
    None → random weights from ``seed``."""
    cls = Monolith if EngineType(engine_type) == EngineType.MONOLITH else EncDec
    if params is None:
        return cls.from_random(config, seed=seed, device=device)
    return cls.from_assets(params, config, vocab_bin=vocab_bin, device=device)
