"""Command line of the port: ``whisper-tpu-torch <subcommand>``, or
``python -m whisper_tpu_torch.cli``.

Counterpart of ``whisper_tpu/cli.py``, with its subcommands, flags and exit
codes:

* ``transcribe`` — audio files to text (batched WAVs, ``--long``,
  ``--sequential``, ``--output-format``);
* ``eval-corpus`` — a manifest of ``wav<TAB>reference`` lines to corpus WER
  and throughput;
* ``serve`` — the HTTP server (``engine/http_server.py``);
* ``vad``, ``silence-removal``, ``wav-to-pcm`` — the audio tools;
* ``pack-assets`` — a reference-format vocab ``.bin`` (``--tokenizer``
  needs ``transformers``);
* ``convert``, ``info`` — checkpoints (``models/convert.py``,
  ``utils/checkpoint.py``);
* ``eval`` — WER between two line-aligned transcript files.

One flag more than JAX's: ``--device`` (default ``cuda``; ``cpu`` runs on
the CPU). ``--mesh d,m`` with d · m > 1 runs one rank of a world of d · m
processes and needs a process group of that size (``torchrun
--nproc-per-node`` d · m), as JAX's ``--mesh`` does: a data axis splits
the batch, a model axis > 1 is tensor parallelism, where each rank reads
only its slice of an npz ``--checkpoint`` (``utils/checkpoint.load_params``).
Usage errors exit 2 with a message. Without ``--checkpoint`` the weights are
random from a seed.
"""

from __future__ import annotations

import argparse
import sys


def _audio_ctx_arg(v: str):
    """--audio-ctx parser: 'auto' | 'none' | int (EngineConfig.audio_ctx)."""
    if v == "auto":
        return "auto"
    if v in ("none", "None", "full"):
        return None
    return int(v)


def _usage_error(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _mesh_shape(spec):
    """``--mesh DATA,MODEL`` → a shape the port runs: more than one rank
    only as one rank of a process group of DATA · MODEL processes."""
    if not spec:
        return (1, 1)
    try:
        d, m = (int(x) for x in spec.split(","))
    except ValueError:
        _usage_error(f"--mesh wants 'data,model' (got {spec!r})")
    if d < 1 or m < 1:
        _usage_error(f"--mesh wants positive sizes (got {spec!r})")
    if d * m > 1:
        from whisper_tpu_torch.parallel.multihost import initialize, world_size

        initialize()  # a launcher's process group (torchrun), if any
        if world_size() != d * m:
            _usage_error(
                f"--mesh {spec} runs one rank of {d * m} processes, here "
                f"{world_size()}: launch it with torchrun --nproc-per-node {d * m}"
            )
    return (d, m)


def _engine_from_args(args):
    """Shared engine construction for transcribe / eval-corpus / serve:
    checkpoint loading and model-family inference, the mesh, the
    EngineConfig. Returns an Engine or raises SystemExit(2) with a
    message."""
    from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    params, shard = None, None
    model = args.model
    mesh_shape = _mesh_shape(args.mesh)
    if args.checkpoint:
        from whisper_tpu_torch.models.convert import load_checkpoint

        if mesh_shape[1] > 1 and args.checkpoint.endswith(".npz"):
            # A tensor-parallel rank reads only its slice of the file.
            from whisper_tpu_torch.parallel.mesh import make_mesh
            from whisper_tpu_torch.utils.checkpoint import load_params

            tp = make_mesh(mesh_shape, device=args.device)
            params, dims = load_params(args.checkpoint, tp, quantization=args.quantize)
            shard = (tp.model_index, tp.model_size)
        else:
            params, dims = load_checkpoint(args.checkpoint)
        inferred = next((k for k, v in MODEL_DIMS.items() if v == dims), None)
        if model is None:
            if inferred is None:
                _usage_error(f"cannot infer model family from {args.checkpoint}; pass --model")
            model = inferred
        elif MODEL_DIMS[model] != dims:
            _usage_error(
                f"checkpoint is {inferred or 'unknown'}-shaped but --model "
                f"{model} was requested"
            )
    model = model or "tiny"

    fallback = None
    if getattr(args, "fallback", False):
        from whisper_tpu_torch.decode.fallback import DEFAULT_TEMPERATURES

        fallback = DEFAULT_TEMPERATURES[1:]  # the retry ladder after the primary
    elif getattr(args, "fallback_temperatures", None):
        try:
            fallback = tuple(float(x) for x in args.fallback_temperatures.split(","))
        except ValueError:
            _usage_error(
                "--fallback-temperatures wants comma-separated floats "
                f"(got {args.fallback_temperatures!r})"
            )

    initial_prompt = None
    if getattr(args, "initial_prompt_tokens", None):
        try:
            initial_prompt = tuple(int(x) for x in args.initial_prompt_tokens.split(","))
        except ValueError:
            _usage_error(
                "--initial-prompt-tokens wants comma-separated ints "
                f"(got {args.initial_prompt_tokens!r})"
            )

    config = EngineConfig(
        model=model,
        language=args.language,
        task=args.task,
        beam_size=args.beam_size,
        max_new_tokens=args.max_new_tokens,
        timestamps=args.timestamps,
        dtype=args.dtype,
        quantization=args.quantize,
        kv_cache_dtype=args.kv_dtype,
        mesh_shape=mesh_shape,
        reference_quirks=args.reference_quirks,
        temperature=getattr(args, "temperature", 0.0),
        fallback_temperatures=fallback,
        word_timestamps=getattr(args, "word_timestamps", False),
        initial_prompt_tokens=initial_prompt,
        initial_prompt=getattr(args, "initial_prompt", None),
        no_speech_threshold=getattr(args, "no_speech_threshold", None),
        fused_step=getattr(args, "fused_step", "auto"),
        audio_ctx=getattr(args, "audio_ctx", "auto"),
        draft_model=getattr(args, "draft_model", None),
        k_draft=getattr(args, "k_draft", 4),
    )
    engine_type = EngineType.ENCDEC if args.engine == "encdec" else EngineType.MONOLITH
    if config.draft_model is not None and config.draft_model not in MODEL_DIMS:
        _usage_error(
            f"unknown --draft-model {config.draft_model!r} "
            f"(choices: {', '.join(sorted(MODEL_DIMS))})"
        )
    draft_params = None
    if getattr(args, "draft_checkpoint", None):
        if config.draft_model is None:
            _usage_error(
                "--draft-checkpoint requires --draft-model "
                "(speculative decoding never activates without it)"
            )
        from whisper_tpu_torch.models.convert import load_checkpoint

        draft_params, ddims = load_checkpoint(args.draft_checkpoint)
        if MODEL_DIMS[config.draft_model] != ddims:
            _usage_error(f"draft checkpoint is not {config.draft_model}-shaped")
    return create_engine(
        engine_type, config, params=params, vocab_bin=args.vocab,
        device=args.device, draft_params=draft_params, shard=shard,
    )


def _cmd_transcribe(args) -> int:
    engine = _engine_from_args(args)
    if getattr(args, "sequential", False):
        # openai's seek loop: sliding window + previous-text conditioning.
        results = [
            engine.transcribe_sequential(p, condition_on_previous_text=not args.no_condition)
            for p in args.inputs
        ]
    elif getattr(args, "long", False):
        # VAD chunks of any duration: each file fans out to one batch.
        results = [engine.transcribe_long(p) for p in args.inputs]
    else:
        wavs = [p for p in args.inputs if not p.endswith((".pcm", ".raw"))]
        if len(wavs) == len(args.inputs) and len(args.inputs) > 1:
            results = engine.transcribe_files(args.inputs)  # one batched run
        else:
            results = [engine.transcribe(p) for p in args.inputs]
    if getattr(args, "output_format", None):
        from whisper_tpu_torch.utils.writers import write_result

        for path, result in zip(args.inputs, results):
            for written in write_result(result, path, args.output_format, args.output_dir):
                print(written, file=sys.stderr)
    for result in results:
        if getattr(result, "chunks", None) is not None:  # long mode
            print(result.text)
            continue
        print(result.clean_text() if args.clean else result.text)
        if result.words:
            for w in result.words:
                print(f"  {w.start:6.2f}-{w.end:6.2f}  {w.word}")
        if args.verbose:
            lang = f"lang {result.language}, " if result.language else ""
            mel = "mel fused" if result.mel_ms is None else f"mel {result.mel_ms:.1f} ms"
            temp = f", T={result.temperature:g}" if result.temperature is not None else ""
            print(
                f"  [{lang}{mel}, model {result.model_ms:.1f} ms, {result.length} tokens{temp}]",
                file=sys.stderr,
            )
    return 0


def _cmd_vad(args) -> int:
    from whisper_tpu_torch.audio import energy_vad, read_pcm_f32

    samples = read_pcm_f32(args.input)
    mask = energy_vad(samples, threshold=args.threshold, frame_size=args.frame_size)
    for i, speech in enumerate(mask):
        print(f"Frame {i}: {'Speech' if speech else 'Silence'}")
    return 0


def _cmd_silence_removal(args) -> int:
    from whisper_tpu_torch.audio import read_pcm_f32, remove_silence

    samples = read_pcm_f32(args.input)
    kept = remove_silence(samples, threshold_db=args.threshold_db, frame_size=args.frame_size)
    kept.astype("<f4").tofile(args.output)
    print(f"kept {len(kept)}/{len(samples)} samples")
    return 0


def _cmd_wav_to_pcm(args) -> int:
    from whisper_tpu_torch.audio.wav import wav_to_pcm

    wav_to_pcm(args.input, args.output)
    return 0


def _cmd_pack_assets(args) -> int:
    from whisper_tpu_torch.frontend.filters import mel_filterbank
    from whisper_tpu_torch.tokenizer.binfmt import write_bin
    from whisper_tpu_torch.tokenizer.vocab import Vocab

    if args.tokenizer:
        try:
            from transformers import WhisperTokenizer
        except ImportError:
            _usage_error("--tokenizer needs the transformers package, which is not installed")
        tok = WhisperTokenizer.from_pretrained(args.tokenizer)
        vocab = Vocab.from_hf_tokenizer(tok, multilingual=args.multilingual)
    else:
        vocab = Vocab.synthetic(multilingual=args.multilingual)
    write_bin(
        args.output,
        mel_filterbank(n_mels=args.n_mels),
        {i: vocab.surface(i) for i in range(max(vocab.id_to_token) + 1)},
        size_prefix=not args.no_size_prefix,
    )
    print(f"wrote {args.output}")
    return 0


def _cmd_convert(args) -> int:
    from whisper_tpu_torch.models.convert import load_checkpoint
    from whisper_tpu_torch.utils.checkpoint import save_params

    params, dims = load_checkpoint(args.checkpoint)
    save_params(args.output, params, dims)
    print(f"converted {args.checkpoint} -> {args.output}")
    return 0


def _cmd_info(args) -> int:
    """What an artifact holds: a checkpoint's dims, parameter count, bytes
    and dtypes, or a vocab .bin's layout."""
    import json

    path = args.artifact
    out = {"path": path}
    if path.endswith(".bin"):
        from whisper_tpu_torch.tokenizer.binfmt import read_bin

        assets = read_bin(path, multilingual=args.multilingual)
        out.update(
            kind="vocab-bin",
            n_mel=int(assets.mel_filters.shape[0]),
            n_fft_bins=int(assets.mel_filters.shape[1]),
            n_vocab_entries=len(assets.vocab.id_to_token),
            multilingual=assets.vocab.multilingual,
        )
    else:
        from whisper_tpu_torch.config import MODEL_DIMS
        from whisper_tpu_torch.models.convert import load_checkpoint
        from whisper_tpu_torch.models.params import count_params, leaves
        from whisper_tpu_torch.models.quantize import is_quantized, param_bytes

        params, dims = load_checkpoint(path)
        inferred = next((k for k, v in MODEL_DIMS.items() if v == dims), None)
        tensors = list(leaves(params))
        out.update(
            kind="checkpoint",
            model=inferred or "unknown",
            dims={
                k: getattr(dims, k)
                for k in (
                    "n_mels", "n_audio_state", "n_audio_head", "n_audio_layer",
                    "n_text_state", "n_text_head", "n_text_layer", "n_vocab",
                    "n_audio_ctx", "n_text_ctx",
                )
            },
            n_params=count_params(params),
            bytes=int(param_bytes(params)),
            dtypes=sorted({str(x.dtype).removeprefix("torch.") for x in tensors}),
            quantized=bool(is_quantized(params)),
        )
    print(json.dumps(out))
    return 0


def _cmd_eval_corpus(args) -> int:
    """Corpus WER: manifest lines are ``<wav_path>\\t<reference text>``;
    batched transcription, normalized word-level WER (``utils/wer.py``),
    the engine's throughput counters."""
    import json
    import time

    from whisper_tpu_torch.utils.wer import word_error_rate

    pairs = []
    with open(args.manifest) as f:
        for ln in f:
            ln = ln.rstrip("\n")
            if not ln or ln.startswith("#"):
                continue
            path, ref = ln.split("\t", 1)
            pairs.append((path, ref))
    if not pairs:
        print("error: empty manifest", file=sys.stderr)
        return 2

    engine = _engine_from_args(args)
    hyps = []
    t0 = time.perf_counter()
    for i in range(0, len(pairs), args.batch_size):
        chunk = [p for p, _ in pairs[i : i + args.batch_size]]
        hyps.extend(r.clean_text() for r in engine.transcribe_files(chunk))
    wall = time.perf_counter() - t0

    if args.hyp_out:
        with open(args.hyp_out, "w") as f:
            f.writelines(h + "\n" for h in hyps)

    result = word_error_rate([r for _, r in pairs], hyps, normalize=not args.no_normalize)
    out = dict(result.as_dict())
    out.update(
        utterances=len(pairs),
        wall_s=round(wall, 3),
        utterances_per_s=round(len(pairs) / wall, 3),
        audio_seconds_per_s=round(engine.throughput.audio_seconds_per_s, 2),
        rtf=round(engine.throughput.rtf, 4),
    )
    print(json.dumps(out))
    return 0


def _cmd_serve(args) -> int:
    from whisper_tpu_torch.engine.http_server import TranscribeServer

    engine = _engine_from_args(args)
    server = TranscribeServer(
        engine, host=args.host, port=args.port, mode=args.mode,
        n_slots=args.slots, max_batch=args.max_batch,
    )
    print(
        f"whisper-tpu-torch serving on http://{server.host}:{server.port} "
        f"(mode={args.mode}) — POST /transcribe, GET /healthz, GET /metrics",
        file=sys.stderr,
    )
    server.serve_forever()
    return 0


def _cmd_eval(args) -> int:
    import json

    from whisper_tpu_torch.utils.wer import word_error_rate

    with open(args.refs) as f:
        refs = [ln.rstrip("\n") for ln in f]
    with open(args.hyps) as f:
        hyps = [ln.rstrip("\n") for ln in f]
    result = word_error_rate(refs, hyps, normalize=not args.no_normalize)
    print(json.dumps(result.as_dict()))
    return 0


def _add_engine_args(p) -> None:
    """Flags shared by every engine-constructing subcommand."""
    p.add_argument("--model", default=None,
                   help="model family (default: inferred from --checkpoint, else tiny)")
    p.add_argument("--checkpoint", default=None, help=".npz, .pt or HF dir")
    p.add_argument("--vocab", default=None, help="reference-format vocab .bin")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs on the CPU)")
    p.add_argument("--engine", choices=["monolith", "encdec"], default="monolith")
    p.add_argument("--language", default=None)
    p.add_argument("--task", choices=["transcribe", "translate"], default="transcribe")
    p.add_argument("--beam-size", type=int, default=1)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--timestamps", action="store_true")
    p.add_argument("--word-timestamps", action="store_true",
                   help="per-word start/end times by DTW over cross-attention "
                   "(one teacher-forced forward per batch)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                   help="mesh of DATA x MODEL ranks, e.g. 2,1 (data parallel) or 1,2 "
                   "(tensor parallel): this process is one rank (launch with torchrun)")
    p.add_argument("--kv-dtype", choices=["float8_e4m3fn", "bfloat16"], default=None,
                   help="KV cache / cross-KV storage dtype (default: compute dtype)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only int8 quantization")
    p.add_argument("--fused-step", choices=["auto", "hybrid", "lineage", "off"], default="auto",
                   help="beam decode-step mode (EngineConfig.fused_step): auto picks "
                   "the hybrid step (K2) on the card, lineage is the kernel-free "
                   "exact alternative, off the eager step with a cache reorder")
    p.add_argument("--audio-ctx", type=_audio_ctx_arg, default="auto",
                   help="encoder-position crop: 'auto' (default) from the batch's "
                   "audio content, an int forces a crop, 'none' the full 30 s window")
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding draft (decode/speculative.py): a small "
                   "model proposes k tokens per round and the target verifies them "
                   "in one forward; the output equals plain greedy. Weights from "
                   "--draft-checkpoint, else random")
    p.add_argument("--k-draft", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    p.add_argument("--draft-checkpoint", default=None,
                   help="checkpoint for --draft-model (.npz | .pt | HF dir)")
    p.add_argument("--reference-quirks", action="store_true",
                   help="bit-parity mode vs the reference binaries: literal "
                   "multilingual prompt and the INT32_MAX stereo downmix")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature of the primary decode (0 = greedy)")
    p.add_argument("--fallback", action="store_true",
                   help="openai-whisper temperature fallback: rows failing the "
                   "compression-ratio / logprob gates decode again at 0.2 .. 1.0")
    p.add_argument("--fallback-temperatures", default=None, metavar="T1,T2,...",
                   help="custom retry temperature ladder (implies the quality gates)")
    p.add_argument("--no-speech-threshold", type=float, default=None, metavar="P",
                   help="silence gate: empty text when P(<|nospeech|>) at SOT "
                   "exceeds P; a confident avg-logprob overrides")
    prompt_group = p.add_mutually_exclusive_group()
    prompt_group.add_argument("--initial-prompt", default=None, metavar="TEXT",
                              help="conditioning context as text (openai initial_prompt), "
                              "BPE-encoded and placed after <|startofprev|>")
    prompt_group.add_argument("--initial-prompt-tokens", default=None, metavar="ID1,ID2,...",
                              help="conditioning context as raw token ids")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="whisper-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("transcribe", help="transcribe audio files")
    t.add_argument("inputs", nargs="+", help="wav/pcm files")
    _add_engine_args(t)
    t.add_argument("--clean", action="store_true", help="collapse extra spaces")
    t.add_argument("--verbose", action="store_true")
    long_mode = t.add_mutually_exclusive_group()
    long_mode.add_argument("--long", action="store_true",
                           help="any duration: VAD-segmented chunks, one batched run")
    long_mode.add_argument("--sequential", action="store_true",
                           help="any duration: openai's seek loop with previous-text "
                           "conditioning")
    t.add_argument("--no-condition", action="store_true",
                   help="no previous-text conditioning in --sequential")
    t.add_argument("--output-format", default=None,
                   choices=["txt", "srt", "vtt", "tsv", "json", "all"],
                   help="also write <basename>.<fmt> per input")
    t.add_argument("--output-dir", default=".", help="directory for --output-format files")
    t.set_defaults(fn=_cmd_transcribe)

    ec = sub.add_parser("eval-corpus", help="transcribe a manifest (wav<TAB>reference "
                        "text per line) and report corpus WER + throughput")
    ec.add_argument("--manifest", required=True)
    ec.add_argument("--batch-size", type=int, default=16)
    ec.add_argument("--no-normalize", action="store_true")
    ec.add_argument("--hyp-out", default=None, help="also write hypotheses, one per line")
    _add_engine_args(ec)
    ec.set_defaults(fn=_cmd_eval_corpus)

    sv = sub.add_parser("serve", help="HTTP transcription server: POST /transcribe "
                        "with WAV bytes")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080)
    sv.add_argument("--mode", choices=["continuous", "async", "sync"], default="continuous")
    sv.add_argument("--slots", type=int, default=8, help="decode slot pool size (continuous)")
    sv.add_argument("--max-batch", type=int, default=8, help="micro-batch cap (async)")
    _add_engine_args(sv)
    sv.set_defaults(fn=_cmd_serve)

    v = sub.add_parser("vad", help="per-frame energy VAD")
    v.add_argument("--input", required=True, help="raw float32 PCM")
    v.add_argument("--threshold", type=float, default=0.01)
    v.add_argument("--frame-size", type=int, default=512)
    v.set_defaults(fn=_cmd_vad)

    s = sub.add_parser("silence-removal", help="drop sub-threshold frames")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--threshold-db", type=float, default=-35.0)
    s.add_argument("--frame-size", type=int, default=512)
    s.set_defaults(fn=_cmd_silence_removal)

    w = sub.add_parser("wav-to-pcm", help="strip WAV container")
    w.add_argument("input")
    w.add_argument("output")
    w.set_defaults(fn=_cmd_wav_to_pcm)

    a = sub.add_parser("pack-assets", help="write reference-format .bin")
    a.add_argument("--output", required=True)
    a.add_argument("--tokenizer", default=None, help="HF tokenizer dir")
    a.add_argument("--multilingual", action="store_true")
    a.add_argument("--n-mels", type=int, default=80)
    a.add_argument("--no-size-prefix", action="store_true")
    a.set_defaults(fn=_cmd_pack_assets)

    c = sub.add_parser("convert", help="convert a checkpoint to the npz interchange file")
    c.add_argument("--checkpoint", required=True)
    c.add_argument("--output", required=True)
    c.set_defaults(fn=_cmd_convert)

    i = sub.add_parser("info", help="inspect an artifact: checkpoint (npz/.pt/HF dir) "
                       "dims/params/dtypes or vocab .bin layout")
    i.add_argument("artifact")
    i.add_argument("--multilingual", action="store_true",
                   help="for .bin files: interpret specials as multilingual")
    i.set_defaults(fn=_cmd_info)

    e = sub.add_parser("eval", help="corpus WER between reference and hypothesis "
                       "transcripts (line-aligned files)")
    e.add_argument("--refs", required=True, help="reference transcripts, one per line")
    e.add_argument("--hyps", required=True, help="hypothesis transcripts, one per line")
    e.add_argument("--no-normalize", action="store_true")
    e.set_defaults(fn=_cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except SystemExit as e:  # usage errors
        return int(e.code or 0)


if __name__ == "__main__":
    sys.exit(main())
