"""Transcript output writers: txt / json / srt / vtt / tsv.

Counterpart of ``whisper_tpu/utils/writers.py`` (the port keeps its own
copy), over the port's ``TranscriptionResult`` and
``LongTranscriptionResult``. The formats are openai-whisper's:

* ``srt``  — 1-based cue index, ``HH:MM:SS,mmm --> HH:MM:SS,mmm`` (comma
  decimal marker, hours always present), blank line between cues.
* ``vtt``  — ``WEBVTT`` header, ``MM:SS.mmm`` (hours only when nonzero),
  dot decimal marker.
* ``tsv``  — header ``start\tend\ttext``; start/end in integer milliseconds.
* ``txt``  — plain text, one segment per line.
* ``json`` — text, language, and per-segment dicts with word timing when
  present.

Every writer reads the same normalized segments: a result decoded without
``timestamps=True`` becomes one cue spanning the utterance (its words bound
the end when present), and the chunks of a long-form result are flattened
with their window offsets added.
"""

from __future__ import annotations

import json
import os
from typing import IO, Any, Dict, Iterable, Iterator, List, Optional

WINDOW_SECONDS = 30.0  # Whisper's fixed audio window (config.N_SAMPLES / sr)


def format_timestamp(
    seconds: float,
    always_include_hours: bool = False,
    decimal_marker: str = ".",
) -> str:
    """``seconds`` → ``[HH:]MM:SS<marker>mmm`` with millisecond rounding."""
    if seconds < 0:
        seconds = 0.0
    milliseconds = round(seconds * 1000.0)

    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000

    hours_marker = (
        f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    )
    return (
        f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}"
        f"{milliseconds:03d}"
    )


def _word_dicts(words, offset: float) -> List[Dict[str, Any]]:
    return [
        {
            "word": w.word,
            "start": round(w.start + offset, 3),
            "end": round(w.end + offset, 3),
        }
        for w in words
    ]


def _chunk_segments(result, offset: float) -> Iterator[Dict[str, Any]]:
    """One TranscriptionResult → segment dicts with ``offset`` added."""
    words = list(result.words) if getattr(result, "words", None) else []
    if getattr(result, "is_silent", False):
        return
    if result.segments:
        segs = result.segments
        # Attach every word to exactly one segment: its covering segment,
        # else the last segment starting at/before it (clamped to the first)
        # — words landing in inter-segment gaps or exactly at the final
        # segment's end must not be dropped.
        assigned: List[list] = [[] for _ in segs]
        for w in words:
            idx = None
            for i, seg in enumerate(segs):
                if seg.start <= w.start < seg.end:
                    idx = i
                    break
            if idx is None:
                idx = 0
                for i, seg in enumerate(segs):
                    if seg.start <= w.start:
                        idx = i
            assigned[idx].append(w)
        for seg, seg_words_list in zip(segs, assigned):
            seg_words = seg_words_list or None
            yield {
                "start": round(seg.start + offset, 3),
                "end": round(seg.end + offset, 3),
                "text": seg.text,
                **(
                    {"words": _word_dicts(seg_words, offset)}
                    if seg_words
                    else {}
                ),
            }
        return
    text = result.clean_text().strip()
    if not text:
        return
    # No timestamp grammar in the decode: one cue for the utterance. Word
    # alignments give the tight end bound when present.
    end = max((w.end for w in words), default=WINDOW_SECONDS)
    yield {
        "start": round(offset, 3),
        "end": round(end + offset, 3),
        "text": text,
        **({"words": _word_dicts(words, offset)} if words else {}),
    }


def iter_segments(result) -> Iterator[Dict[str, Any]]:
    """Normalized ``{start, end, text[, words]}`` dicts (absolute seconds)
    from a TranscriptionResult or LongTranscriptionResult."""
    chunks = getattr(result, "chunks", None)
    if chunks is not None:  # LongTranscriptionResult
        for offset, chunk in zip(result.offsets, chunks):
            yield from _chunk_segments(chunk, offset)
    else:
        yield from _chunk_segments(result, 0.0)


def _result_text(result) -> str:
    if getattr(result, "chunks", None) is not None:
        return result.text
    return result.clean_text().strip()


def write_txt(result, file: IO[str]) -> None:
    wrote = False
    for seg in iter_segments(result):
        print(seg["text"].strip(), file=file)
        wrote = True
    if not wrote:
        print(_result_text(result), file=file)


def write_srt(result, file: IO[str]) -> None:
    for i, seg in enumerate(iter_segments(result), start=1):
        start = format_timestamp(
            seg["start"], always_include_hours=True, decimal_marker=","
        )
        end = format_timestamp(
            seg["end"], always_include_hours=True, decimal_marker=","
        )
        print(f"{i}\n{start} --> {end}\n{seg['text'].strip()}\n", file=file)


def write_vtt(result, file: IO[str]) -> None:
    print("WEBVTT\n", file=file)
    for seg in iter_segments(result):
        start = format_timestamp(seg["start"])
        end = format_timestamp(seg["end"])
        print(f"{start} --> {end}\n{seg['text'].strip()}\n", file=file)


def write_tsv(result, file: IO[str]) -> None:
    print("start\tend\ttext", file=file)
    for seg in iter_segments(result):
        start = round(1000.0 * seg["start"])
        end = round(1000.0 * seg["end"])
        print(f"{start}\t{end}\t{seg['text'].strip()}", file=file)


def write_json(result, file: IO[str]) -> None:
    chunks = getattr(result, "chunks", None)
    language = (
        chunks[0].language if chunks else getattr(result, "language", "")
    )
    out: Dict[str, Any] = {
        "text": _result_text(result),
        "language": language,
        "segments": list(iter_segments(result)),
    }
    first = chunks[0] if chunks else result
    for key in ("temperature", "avg_logprob", "compression_ratio",
                "no_speech_prob"):
        value = getattr(first, key, None)
        if value is not None:
            out[key] = value
    json.dump(out, file, ensure_ascii=False, indent=2)
    file.write("\n")


WRITERS = {
    "txt": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
    "json": write_json,
}

OUTPUT_FORMATS = tuple(WRITERS) + ("all",)


def write_result(
    result,
    audio_path: str,
    output_format: str,
    output_dir: str = ".",
) -> List[str]:
    """Write ``result`` next to ``audio_path``'s basename in ``output_dir``.

    ``output_format`` is one of OUTPUT_FORMATS; ``"all"`` writes every
    format. Returns the list of paths written."""
    formats = list(WRITERS) if output_format == "all" else [output_format]
    if unknown := set(formats) - set(WRITERS):
        raise ValueError(f"unknown output format(s): {sorted(unknown)}")
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(audio_path))[0]
    written = []
    for fmt in formats:
        path = os.path.join(output_dir, f"{base}.{fmt}")
        with open(path, "w", encoding="utf-8") as fh:
            WRITERS[fmt](result, fh)
        written.append(path)
    return written
