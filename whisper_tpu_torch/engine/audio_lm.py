"""The engine of an audio language model (``config.AUDIO_LM_DIMS``):
``create_engine`` returns an :class:`AudioLM` for such a model name.

``transcribe_batch`` runs, for a batch of clips: int16 shipping, log-mel
and the Whisper encoder over the 30-s window (K1, as the Whisper engines
run them), the crop to the tower's ``audio_ctx`` positions, the pool and
the projector (span ``lm.project``), the prefix of each row (its text ids
before, its own audio positions, its text ids after; left-padded to the
longest) and the greedy loop of ``decode/greedy.lm_greedy_decode`` (the
prefill, span ``lm.prefill``, then each step replayed as a CUDA graph on
the card). It returns one :class:`TranscriptionResult` a clip with the
generated token ids (``tokens``: ``max_new_tokens`` of them, the stop id
after the first stop; ``length``: ids up to and including the stop) and no
text: detokenising needs the model's tokenizer files.

Each batch records the Whisper engines' spans (``engine.batch`` with its
number, ``engine.prepare``, ``engine.encode``, ``decode.loop``,
``decode.step``, ``decode.sync``, ``engine.fetch``, ``engine.results``)
and reads the routing counters (``models/audio_lm.new_counters``) back in
the same copy as its tokens, into ``models.audio_lm.routing``, and keeps
the routing of every position of the batch in :attr:`AudioLM.last_routing`
(for a judge that holds it against a reference's).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from whisper_tpu_torch.config import AUDIO_LM_DIMS, N_SAMPLES, EngineConfig
from whisper_tpu_torch.decode import greedy as greedy_mod
from whisper_tpu_torch.decode.graph import StepGraphs
from whisper_tpu_torch.frontend.filters import mel_filterbank
from whisper_tpu_torch.models import audio_lm
from whisper_tpu_torch.models.params import Params, to_device
from whisper_tpu_torch.utils.profiling import StageTimer, Throughput, annotate, next_number

DEFAULT_MAX_NEW = 224


class AudioLM:
    """An audio language model's offline engine (greedy, no mesh)."""

    def __init__(self, params: Params, config: EngineConfig, device="cuda"):
        from whisper_tpu_torch.engine.engine import resolve_device

        dims = AUDIO_LM_DIMS[config.model]
        unsupported = {
            "beam_size": config.beam_size != 1, "temperature": config.temperature != 0,
            "fallback_temperatures": bool(config.fallback_temperatures),
            "quantization": config.quantization is not None,
            "kv_cache_dtype": config.kv_cache_dtype is not None,
            "mesh_shape": int(np.prod(config.mesh_shape)) > 1,
            "draft_model": config.draft_model is not None,
            "word_timestamps": config.word_timestamps, "timestamps": config.timestamps,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"{config.model}: greedy bf16/f32 decoding only; unsupported: {bad}")
        if config.audio_ctx not in ("auto", None, dims.audio_ctx):
            raise ValueError(f"{config.model} reads {dims.audio_ctx} tower positions, "
                             f"not audio_ctx={config.audio_ctx!r}")
        self.device = resolve_device(device)
        self.config = config
        self.dims = dims
        self.params = to_device(params, self.device)
        self._filters = torch.tensor(mel_filterbank(n_mels=dims.tower.n_mels), device=self.device)
        text = list(config.lm_prefix_tokens) + list(config.lm_suffix_tokens)
        if any(not 0 <= t < dims.n_vocab for t in text):
            raise ValueError(f"{config.model}: text ids must lie in [0, {dims.n_vocab})")
        self._text = torch.tensor(text, dtype=torch.long).to(self.device)
        self._max_new = config.max_new_tokens or DEFAULT_MAX_NEW
        if len(text) + dims.audio_ctx // dims.pool + self._max_new > dims.n_ctx:
            raise ValueError(f"{config.model}: the prompt and the budget exceed {dims.n_ctx}")
        self._graphs = StepGraphs() if self.device.type == "cuda" else None
        self.counters = audio_lm.new_counters(dims, self.device)
        self._counted = np.zeros(tuple(self.counters.shape), np.int64)  # read so far
        self.timer = StageTimer()
        self.throughput = Throughput()
        # The last batch's routing, a row at a time: (its prefix positions
        # [L, n, K], its steps [L, max_new_tokens, K]; index g: the step that
        # fed generated token g), ``audio_lm.route_codes``' int8 codes.
        self.last_routing: List[tuple] = []

    @classmethod
    def from_random(cls, config: EngineConfig, seed: int = 0, device="cuda") -> "AudioLM":
        from whisper_tpu_torch.engine.engine import resolve_device

        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = audio_lm.init_lm_params(AUDIO_LM_DIMS[config.model], gen,
                                         dtype=getattr(torch, config.dtype), device=device)
        return cls(params, config, device=device)

    # --- host side ---------------------------------------------------------
    def _prepare(self, samples, lengths: Optional[Sequence[int]]):
        """Clips (a list of 1-D arrays, or rows of a 2-D array) → the int16
        host batch [B, 30 s] and each clip's samples (given, the list's
        lengths, or a row's last non-zero sample + 1)."""
        from whisper_tpu_torch.engine.engine import to_int16

        rows = [np.asarray(r, np.float32).reshape(-1) for r in samples]
        if lengths is None:
            if isinstance(samples, np.ndarray) and samples.ndim == 2:
                lengths = [int(np.flatnonzero(r)[-1]) + 1 if r.any() else 0 for r in rows]
            else:
                lengths = [len(r) for r in rows]
        n = np.minimum(np.asarray(lengths, np.int64), N_SAMPLES)
        batch = np.zeros((len(rows), N_SAMPLES), np.int16)
        for i, r in enumerate(rows):
            batch[i, : n[i]] = to_int16(r[: n[i]])
        return batch, n

    def transcribe_batch(self, samples: Union[np.ndarray, Sequence[np.ndarray]],
                         lengths: Optional[Sequence[int]] = None) -> List:
        """One batch of clips (each ≤ 30 s; the tower reads the first
        ``audio_ctx`` positions, 20 s at the published size) → one result
        a clip."""
        from whisper_tpu_torch.engine.engine import TranscriptionResult, _samples_f32, encode_samples

        dims = self.dims
        with annotate("engine.batch", trace_id=next_number()) as root:
            with annotate("engine.prepare"):
                batch, n = self._prepare(samples, lengths)
                b = batch.shape[0]
                n_audio = [audio_lm.audio_positions(int(k), dims) for k in n]
                n_pre = len(self.config.lm_prefix_tokens)
                layout = audio_lm.prefix_layout(n_audio, n_pre, len(self._text) - n_pre,
                                                dims.audio_ctx // dims.pool)
            t0 = time.perf_counter()
            steps0 = greedy_mod.steps
            # Every upload first: a copy from pageable memory waits for the card.
            x = torch.from_numpy(batch).to(self.device)
            src = torch.from_numpy(layout["src"]).to(self.device)
            pad = torch.from_numpy(layout["pad"]).to(self.device)
            enc = encode_samples(self.params["tower"], _samples_f32(x), self._filters, dims.tower,
                                 self._dtype)
            with annotate("lm.project", device=self.device):
                audio = audio_lm.project(self.params, enc, dims)
                prefix = audio_lm.embed_prefix(self.params, audio, self._text, src)
            del enc, audio
            routes: dict = {}
            tokens, lens = greedy_mod.lm_greedy_decode(
                self.params, prefix, pad, dims, self._max_new, self.counters, self._graphs, routes)
            tokens, lens = self._to_host(tokens, lens, routes, layout["pad"])
            model_ms = (time.perf_counter() - t0) * 1e3
            with annotate("engine.results"):
                self.timer.record("model", model_ms / 1e3)
                self.throughput.add(audio_seconds=float(n.sum()) / 16_000.0,
                                    tokens=int(lens.sum()), utterances=b, wall_s=model_ms / 1e3)
                results = [TranscriptionResult(text="", tokens=tokens[i], length=int(lens[i]),
                                               model_ms=model_ms) for i in range(b)]
            root.set(rows=b, padded_rows=b, audio_ctx=dims.audio_ctx,
                     steps=greedy_mod.steps - steps0, encoder_rows=b, prefix_len=layout["P"])
        return results

    @property
    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.config.dtype)

    def _to_host(self, tokens: torch.Tensor, lens: torch.Tensor, routes: dict, pad: np.ndarray):
        """Tokens, lengths and the routing counters in one copy to the host;
        the counters' growth since the last read goes to
        ``models.audio_lm.routing``. Then, the card idle, the routing of
        every position into :attr:`last_routing`."""
        with annotate("engine.fetch"):
            b, t = tokens.shape
            flat = torch.cat([tokens.reshape(-1), lens.reshape(-1).long(),
                              self.counters.reshape(-1)]).cpu().numpy()
            pre, step = routes["prefill"].cpu().numpy(), routes["step"].cpu().numpy()
        now = flat[b * t + b:].reshape(self._counted.shape)
        audio_lm.add_routing(now - self._counted, self.dims)
        self._counted = now
        self.last_routing = [(pre[:, i, int(pad[i]):], step[:, i]) for i in range(b)]
        return flat[: b * t].reshape(b, t).astype(np.int32), flat[b * t: b * t + b].astype(np.int32)
