"""Transcript output writers: txt / srt / vtt / tsv / json (a copy of the
JAX package's `utils/writers.py`, which the port cannot import).

Subtitle writers (srt/vtt) support openai's word-level options
(whisper/utils.py semantics, reimplemented): max_line_width /
max_line_count / max_words_per_line re-chunk subtitles from per-word
timings (which need word timestamps); highlight_words emits one cue per
word with the active word underlined (<u>...</u>). Without word timings
every writer is segment-level.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, TextIO, Tuple


def _srt_time(seconds: float) -> str:
    ms = round(seconds * 1000)
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def _vtt_time(seconds: float) -> str:
    return _srt_time(seconds).replace(",", ".")


def write_txt(result: Dict[str, Any], f: TextIO, **_: Any) -> None:
    for seg in result["segments"]:
        print(seg["text"].strip(), file=f)


def _iterate_subtitles(
    segments: List[Dict[str, Any]],
    max_line_width: Optional[int],
    max_line_count: Optional[int],
    max_words_per_line: Optional[int],
) -> Iterator[List[Dict[str, Any]]]:
    """Group word timings into subtitle chunks (openai iterate_subtitles):
    lines wrap at max_line_width characters; a subtitle closes after
    max_line_count lines, a >3 s pause (when not preserving segment
    boundaries), or max_words_per_line words per line-chunk."""
    preserve_segments = max_line_count is None or max_line_width is None
    line_width = max_line_width or 1000
    words_per_line = max_words_per_line or 1000

    line_len = 0
    line_count = 1
    subtitle: List[Dict[str, Any]] = []
    last = next((w["start"] for s in segments
                 for w in (s.get("words") or [])), 0.0)
    for segment in segments:
        words = segment.get("words") or []
        chunk_index = 0
        while chunk_index < len(words):
            chunk = words[chunk_index : chunk_index + words_per_line]
            for i, original in enumerate(chunk):
                timing = dict(original)
                long_pause = (not preserve_segments
                              and timing["start"] - last > 3.0)
                has_room = line_len + len(timing["word"]) <= line_width
                seg_break = i == 0 and subtitle and preserve_segments
                if line_len > 0 and has_room and not long_pause \
                        and not seg_break:
                    line_len += len(timing["word"])
                else:
                    timing["word"] = timing["word"].strip()
                    if (subtitle and max_line_count is not None
                            and (long_pause or line_count >= max_line_count)
                            ) or seg_break:
                        yield subtitle
                        subtitle = []
                        line_count = 1
                    elif line_len > 0:
                        line_count += 1
                        timing["word"] = "\n" + timing["word"]
                    line_len = len(timing["word"].strip())
                subtitle.append(timing)
                last = timing["start"]
            chunk_index += words_per_line
    if subtitle:
        yield subtitle


def _iterate_cues(result: Dict[str, Any],
                  options: Dict[str, Any]) -> Iterator[Tuple[float, float, str]]:
    """(start, end, text) cues; word-level when words exist and any
    word-level option is set, else one cue per segment."""
    segments = result["segments"]
    word_opts = ("max_line_width", "max_line_count", "max_words_per_line",
                 "highlight_words")
    wordy = (segments and segments[0].get("words") is not None
             and any(options.get(k) for k in word_opts))
    if not wordy:
        for seg in segments:
            yield seg["start"], seg["end"], seg["text"].strip()
        return
    for subtitle in _iterate_subtitles(
            segments, options.get("max_line_width"),
            options.get("max_line_count"), options.get("max_words_per_line")):
        sub_start = subtitle[0]["start"]
        sub_end = subtitle[-1]["end"]
        sub_text = "".join(w["word"] for w in subtitle)
        if options.get("highlight_words"):
            last = sub_start
            all_words = [w["word"] for w in subtitle]
            for i, this_word in enumerate(subtitle):
                start, end = this_word["start"], this_word["end"]
                if last != start:
                    yield last, start, sub_text
                yield start, end, "".join(
                    re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word)
                    if j == i else word
                    for j, word in enumerate(all_words))
                last = end
        else:
            yield sub_start, sub_end, sub_text


def write_srt(result: Dict[str, Any], f: TextIO, **options: Any) -> None:
    for i, (start, end, text) in enumerate(_iterate_cues(result, options),
                                           start=1):
        print(f"{i}\n{_srt_time(start)} --> {_srt_time(end)}\n"
              f"{text.strip()}\n", file=f)


def write_vtt(result: Dict[str, Any], f: TextIO, **options: Any) -> None:
    print("WEBVTT\n", file=f)
    for start, end, text in _iterate_cues(result, options):
        print(f"{_vtt_time(start)} --> {_vtt_time(end)}\n"
              f"{text.strip()}\n", file=f)


def write_tsv(result: Dict[str, Any], f: TextIO, **_: Any) -> None:
    print("start\tend\ttext", file=f)
    for seg in result["segments"]:
        print(f"{round(seg['start'] * 1000)}\t{round(seg['end'] * 1000)}\t"
              f"{seg['text'].strip()}", file=f)


def write_json(result: Dict[str, Any], f: TextIO, **_: Any) -> None:
    json.dump(result, f, ensure_ascii=False, indent=2)


WRITERS = {
    "txt": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
    "json": write_json,
}


def write_result(result: Dict[str, Any], audio_path: str, output_dir: str,
                 output_format: str = "txt", **options: Any) -> str:
    """options: word-level subtitle options for srt/vtt (max_line_width,
    max_line_count, max_words_per_line, highlight_words)."""
    formats = list(WRITERS) if output_format == "all" else [output_format]
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(audio_path))[0]
    last = ""
    for fmt in formats:
        if fmt not in WRITERS:
            raise ValueError(f"unknown output format {fmt!r}; "
                             f"available: {sorted(WRITERS)} or 'all'")
        last = os.path.join(output_dir, f"{base}.{fmt}")
        with open(last, "w", encoding="utf-8") as f:
            WRITERS[fmt](result, f, **options)
    return last
