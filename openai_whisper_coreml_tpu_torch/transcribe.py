"""Long-form transcription: 30 s windowing with timestamp-seek (port of
`transcribe.py`).

Slide a 30 s window over the log-mel of the whole file, decode it, advance
the window to the last complete timestamped segment, carry the decoded text
as the next window's prompt, and retry a window at higher temperature when
its output is degenerate (the temperature ladder: greedy or beam at t=0,
sampled `best_of` candidates above). The mel is computed once for the whole
file, on the model's device (the K4 kernel on the card), and each window is
encoded once; the ladder and the word-timestamp pass (`timing.py`) reuse
its features. With word timestamps the window seeks from the last word's
end, and `hallucination_silence_threshold` skips the silence around
segments that look like hallucinations (openai's rules).

With `draft_model` every greedy and sampled rung decodes speculatively
(`speculative.py`), under one acceptance governor per call that withholds
a draft whose acceptance sits below break-even; `spec_fallback=False` in
the decode options turns the governor off, and `spec_k` sets the
proposals per verify step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from . import speculative as spec_mod
from .audio import load_audio, pad_or_trim
from .config import (
    APPEND_PUNCTUATIONS,
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    PREPEND_PUNCTUATIONS,
)
from .decoding import DecodingOptions, DecodingResult, decode
from .tokenizer import get_tokenizer


@dataclasses.dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: List[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    words: Optional[List[Dict[str, Any]]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["words"] is None:
            del d["words"]
        return d


def seek_advance(tokens, ts_begin: int, segment_size: int) -> int:
    """openai's window-advance rule, in mel frames (input_stride == 2)."""
    tokens = np.asarray(tokens, dtype=np.int64)
    timestamp_tokens = tokens >= ts_begin
    single_timestamp_ending = (
        len(timestamp_tokens) >= 2
        and not timestamp_tokens[-2] and timestamp_tokens[-1])
    consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1
    if len(consecutive) > 0 and not single_timestamp_ending:
        last_ts_pos = int(tokens[int(consecutive[-1]) - 1]) - ts_begin
        # a degenerate window whose last timestamp is 0.00 must still advance
        return max(last_ts_pos * 2, 2)
    return segment_size


def window_segment_spans(tokens, ts_begin: int, time_offset: float,
                         segment_duration: float):
    """openai's in-window segmentation rule: split one window's tokens on
    consecutive-timestamp pairs into closed segments (plus the final open
    one when the window ends on a single trailing timestamp); without any
    consecutive pair, the whole window is one segment whose end comes from
    the last non-zero timestamp (else segment_duration). Returns
    [(start_s, end_s, token_slice)], token_slice an int64 array including
    the surrounding timestamp tokens."""
    tokens = np.asarray(tokens, dtype=np.int64)
    is_ts = tokens >= ts_begin
    single_timestamp_ending = (len(is_ts) >= 2
                               and not is_ts[-2] and is_ts[-1])
    consecutive = np.where(is_ts[:-1] & is_ts[1:])[0] + 1
    spans = []
    if len(consecutive) > 0:
        slices = consecutive.tolist()
        if single_timestamp_ending:
            slices.append(len(tokens))
        last = 0
        for cur in slices:
            sliced = tokens[last:cur]
            start_pos = int(sliced[0]) - ts_begin
            end_pos = int(sliced[-1]) - ts_begin
            spans.append((time_offset + start_pos * 0.02,
                          time_offset + end_pos * 0.02, sliced))
            last = cur
    else:
        duration = segment_duration
        ts_in = tokens[is_ts]
        if len(ts_in) > 0 and int(ts_in[-1]) != ts_begin:
            duration = (int(ts_in[-1]) - ts_begin) * 0.02
        spans.append((time_offset, time_offset + duration, tokens))
    return spans


# openai's hallucination heuristics (transcribe.py v20231117): a word is
# anomalous when improbable or implausibly short/long; a segment is a likely
# hallucination when its first non-punctuation words are mostly anomalous.
# They read word timings.
_ANOMALY_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: Dict[str, Any]) -> float:
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment) -> bool:
    if segment is None or not getattr(segment, "words", None):
        return False
    words = [w for w in segment.words
             if w["word"] not in _ANOMALY_PUNCTUATION][:8]
    if not words:
        return False
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _next_words_segment(segments):
    return next((s for s in segments if getattr(s, "words", None)), None)


def _get_end(segments) -> Optional[float]:
    """Timestamp of the last spoken word, else the last segment end."""
    return next(
        (w["end"] for s in reversed(segments)
         for w in reversed(getattr(s, "words", None) or [])),
        segments[-1].end if segments else None,
    )


def transcribe(
    model,
    audio: Union[str, np.ndarray],
    *,
    task: str = "transcribe",
    language: Optional[str] = None,
    temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    without_timestamps: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    clip_timestamps: Union[str, Sequence[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    vad_filter: bool = False,
    vad_parameters=None,  # vad.VadOptions
    progress_callback=None,  # fn(seconds_done: float, total_seconds: float)
    verbose: Optional[bool] = None,
    draft_model=None,  # a smaller WhisperModel sharing the tokenizer
    **decode_options,
) -> Dict[str, Any]:
    """Transcribe (or translate) audio of any length; returns {"text",
    "segments", "language", "duration"} in the openai/whisper schema.

    carry_initial_prompt: prepend initial_prompt to every window's prompt
    (openai v20240930), bounded with the rolling context to the decoder's
    n_text_ctx // 2 - 1 prompt budget. clip_timestamps: "start,end,..."
    seconds (or a list); only audio inside the clips is transcribed (an odd
    count gets the content end appended). vad_filter: the energy VAD
    (`vad.py`) computes the clips. hallucination_silence_threshold acts
    only with word timestamps, as in openai; prepend/append_punctuations
    are for word timestamps too.
    decode_options: the remaining DecodingOptions fields (beam_size,
    best_of, patience, length_penalty, sample_len, kv_dtype, spec_k, ...),
    and spec_fallback (default True: the draft's acceptance governor).
    """
    cfg = model.cfg
    mesh = getattr(model, "mesh", None)
    # one acceptance governor per call: long audio the draft cannot predict
    # would otherwise pay the below-break-even cost on every window. Under
    # a mesh it keeps its prior threshold: walls differ between ranks, and
    # the ranks of a model group must take every branch alike.
    spec_gov = None
    spec_fallback = bool(decode_options.pop("spec_fallback", True))
    if draft_model is not None and spec_fallback:
        spec_gov = spec_mod.SpecGovernor(
            threshold=spec_mod.break_even_tokens_per_iter(
                int(decode_options.get("spec_k", 4)), batch=1),
            pinned=mesh is not None)

    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim != 1:
        raise ValueError(f"transcribe expects mono audio, got {audio.shape}")

    if vad_filter:
        # energy VAD -> the clip_timestamps machinery: only detected speech
        # spans reach the decode loop
        if clip_timestamps != "0":
            raise ValueError(
                "vad_filter computes clip_timestamps itself; pass either "
                "vad_filter=True or explicit clip_timestamps, not both")
        from .vad import VadOptions, speech_clip_timestamps

        clips = speech_clip_timestamps(
            audio, options=vad_parameters or VadOptions())
        if not clips:
            return {"text": "", "segments": [],
                    "language": language or "en"}
        clip_timestamps = clips
        if verbose:
            spans = ", ".join(f"{clips[i]:.2f}-{clips[i+1]:.2f}"
                              for i in range(0, len(clips), 2))
            print(f"VAD speech spans: {spans}")

    # Full-length mel plus one window of trailing padding (so the final
    # window is always complete), openai semantics. The length is bucketed
    # to a power-of-two count of 30 s chunks, as in JAX, then sliced back to
    # the true frame count, so the seek logic sees the same mel.
    n_samples_ceil = ((len(audio) + HOP_LENGTH - 1) // HOP_LENGTH) * HOP_LENGTH
    chunks = max(1, -(-n_samples_ceil // N_SAMPLES))
    bucket_chunks = 1 << (chunks - 1).bit_length()
    padded = np.zeros(bucket_chunks * N_SAMPLES + N_SAMPLES, dtype=np.float32)
    padded[: len(audio)] = audio
    mel = model.log_mel(padded)
    mel = mel[..., : n_samples_ceil // HOP_LENGTH + N_FRAMES]
    content_frames = mel.shape[-1] - N_FRAMES
    content_duration = content_frames / FRAMES_PER_SECOND

    # --- language ---------------------------------------------------------
    if language is None:
        if not cfg.multilingual:
            language = "en"
        else:
            codes, _ = model.detect_language(
                pad_or_trim(mel[:, :N_FRAMES], N_FRAMES, axis=-1)[None])
            language = codes[0]
            if verbose:
                print(f"Detected language: {language}")

    tokenizer = get_tokenizer(cfg, language=language if cfg.multilingual else None,
                              task=task)

    temperatures = ([temperature] if isinstance(temperature, (int, float))
                    else list(temperature))

    all_tokens: List[int] = []
    all_segments: List[Segment] = []
    prompt_reset_since = 0

    remaining_prompt_length = cfg.n_text_ctx // 2 - 1
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
        remaining_prompt_length -= len(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    def decode_with_fallback(segment_feats) -> DecodingResult:
        """segment_feats: (1, 1500, n_state), encoded once per window; every
        rung of the ladder reuses them."""
        result: Optional[DecodingResult] = None
        if carry_initial_prompt:
            # the initial prompt rides along in every window, ahead of a
            # budget-bounded rolling context tail
            nignored = max(len(initial_prompt_tokens), prompt_reset_since)
            remaining = (all_tokens[nignored:][-remaining_prompt_length:]
                         if remaining_prompt_length > 0 else [])
            prompt = initial_prompt_tokens + remaining
        else:
            # the tail since the last reset (openai): with conditioning off
            # the reset advances after every window, so the initial prompt
            # conditions window 1 only
            prompt = all_tokens[prompt_reset_since:]
        for t in temperatures:
            # beam search only on the greedy rung (t=0); the sampled rungs
            # use best_of candidates instead
            rung_options = dict(decode_options)
            if t > 0:
                rung_options.pop("beam_size", None)
                rung_options.pop("patience", None)
            else:
                rung_options.pop("best_of", None)
            opts = DecodingOptions(
                task=task,
                language=language if cfg.multilingual else None,
                temperature=float(t),
                prompt=prompt or None,
                without_timestamps=without_timestamps,
                **rung_options,
            )
            # the draft rides greedy and sampled rungs (decode routes
            # best_of fan-outs and beam to the plain loop), each regime
            # judged by the governor apart
            result = spec_mod.governed_decode(
                spec_gov, draft_model,
                lambda d: decode(model, segment_feats, opts, from_features=True,
                                 draft=d),
                sampled=float(t) > 0)[0]

            needs_fallback = False
            if (compression_ratio_threshold is not None
                    and result.compression_ratio > compression_ratio_threshold):
                needs_fallback = True  # repetitive/degenerate
            if (logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold):
                needs_fallback = True  # low confidence
            if (no_speech_threshold is not None
                    and result.no_speech_prob > no_speech_threshold):
                needs_fallback = False  # silence: accept and let caller skip
            if not needs_fallback:
                break
        assert result is not None
        return result

    # one timestamp token step = 0.02 s = 2 mel frames (input stride)
    ts_begin = cfg.timestamp_begin

    # --- clip windows (openai clip_timestamps semantics) ------------------
    if isinstance(clip_timestamps, str):
        clip_list = [float(ts) for ts in
                     (clip_timestamps.split(",") if clip_timestamps else [])]
    else:
        clip_list = [float(ts) for ts in clip_timestamps]
    seek_points = [
        min(max(0, round(ts * FRAMES_PER_SECOND)), content_frames)
        for ts in clip_list]
    if len(seek_points) == 0:
        seek_points = [0]
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips = list(zip(seek_points[::2], seek_points[1::2]))

    clip_idx = 0
    seek = seek_clips[0][0]
    last_speech_timestamp = 0.0

    while clip_idx < len(seek_clips):
        if progress_callback is not None:
            progress_callback(
                round(min(seek / FRAMES_PER_SECOND, content_duration), 2),
                round(content_duration, 2))
        seek_clip_start, seek_clip_end = seek_clips[clip_idx]
        if seek < seek_clip_start:
            seek = seek_clip_start
        if seek >= seek_clip_end:
            clip_idx += 1
            if clip_idx < len(seek_clips):
                seek = seek_clips[clip_idx][0]
            continue
        time_offset = seek / FRAMES_PER_SECOND
        window_end_time = (seek + N_FRAMES) / FRAMES_PER_SECOND
        segment_size = min(N_FRAMES, content_frames - seek,
                           seek_clip_end - seek)
        segment_duration = segment_size / FRAMES_PER_SECOND
        # openai slices the window at segment_size and zero-pads the mel back
        # to N_FRAMES: a final partial window decodes against zero mel
        # columns, not the silence-mel of the padded audio
        segment_mel = pad_or_trim(mel[:, seek : seek + segment_size], N_FRAMES)

        segment_feats = model.encode(segment_mel[None])
        result = decode_with_fallback(segment_feats)
        tokens = np.asarray(result.tokens, dtype=np.int64)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if (logprob_threshold is not None
                    and result.avg_logprob > logprob_threshold):
                should_skip = False  # confident despite no_speech
            if should_skip:
                seek += segment_size
                continue

        previous_seek = seek
        current_segments: List[Segment] = []
        for span_start, span_end, sliced in window_segment_spans(
                tokens, ts_begin, time_offset, segment_duration):
            seg_tokens = sliced.tolist()
            current_segments.append(Segment(
                id=0,  # renumbered at the end
                seek=previous_seek,
                start=span_start,
                end=span_end,
                text=tokenizer.decode([t for t in seg_tokens
                                       if t < tokenizer.eot]),
                tokens=seg_tokens,
                temperature=result.temperature,
                avg_logprob=result.avg_logprob,
                compression_ratio=result.compression_ratio,
                no_speech_prob=result.no_speech_prob,
            ))
        seek += seek_advance(tokens, ts_begin, segment_size)
        is_ts = tokens >= ts_begin
        single_timestamp_ending = (
            len(is_ts) >= 2 and not is_ts[-2] and is_ts[-1])

        if word_timestamps and current_segments:
            from .timing import add_word_timestamps_to_segments

            # the window's own features: no second encode
            add_word_timestamps_to_segments(
                model, tokenizer, current_segments, segment_feats,
                num_frames=segment_size, time_offset=time_offset,
                language=language,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=last_speech_timestamp)
            if not single_timestamp_ending:
                last_word_end = _get_end(current_segments)
                if last_word_end is not None and last_word_end > time_offset:
                    # the last word's end is a better seek point than the
                    # last timestamp token (openai)
                    seek = round(last_word_end * FRAMES_PER_SECOND)

            # skip the silence around likely hallucinations (openai's rules)
            if hallucination_silence_threshold is not None:
                threshold = hallucination_silence_threshold
                if not single_timestamp_ending:
                    last_word_end = _get_end(current_segments)
                    if (last_word_end is not None
                            and last_word_end > time_offset):
                        remaining = window_end_time - last_word_end
                        if remaining > threshold:
                            seek = round(last_word_end * FRAMES_PER_SECOND)
                        else:
                            seek = previous_seek + segment_size

                # a hallucinated first segment: drop the window and decode
                # again past the leading silence
                first_segment = _next_words_segment(current_segments)
                if (first_segment is not None
                        and _is_segment_anomaly(first_segment)):
                    gap = first_segment.start - time_offset
                    if gap > threshold:
                        seek = previous_seek + max(
                            1, round(gap * FRAMES_PER_SECOND))
                        continue

                # a hallucination with silence (or more hallucinations) on
                # both sides: seek to it, drop it and what follows
                hal_last_end = last_speech_timestamp
                for si, segment in enumerate(current_segments):
                    if not segment.words:
                        continue
                    if _is_segment_anomaly(segment):
                        next_seg = _next_words_segment(
                            current_segments[si + 1:])
                        if next_seg is not None:
                            hal_next_start = next_seg.words[0]["start"]
                        else:
                            hal_next_start = time_offset + segment_duration
                        silence_before = (
                            segment.start - hal_last_end > threshold
                            or segment.start < threshold
                            or segment.start - time_offset < 2.0)
                        silence_after = (
                            hal_next_start - segment.end > threshold
                            or _is_segment_anomaly(next_seg)
                            or window_end_time - segment.end < 2.0)
                        if silence_before and silence_after:
                            seek = round(
                                max(time_offset + 1, segment.start)
                                * FRAMES_PER_SECOND)
                            if content_duration - segment.end < threshold:
                                seek = content_frames
                            del current_segments[si:]
                            break
                    hal_last_end = segment.end

            last_word_end = _get_end(current_segments)
            if last_word_end is not None:
                last_speech_timestamp = last_word_end

        if seek <= previous_seek:
            # a word-end seek that rounds back to the window's start would
            # decode the same window again forever: advance fully instead
            seek = previous_seek + segment_size

        if verbose:
            for seg in current_segments:
                print(f"[{_fmt_time(seg.start)} --> {_fmt_time(seg.end)}]"
                      f" {seg.text}")

        # openai: instantaneous or text-less segments are kept but emptied;
        # their tokens must not condition later windows
        for seg in current_segments:
            if seg.start == seg.end or not seg.text.strip():
                seg.text = ""
                seg.tokens = []
                seg.words = [] if word_timestamps else None

        all_segments.extend(current_segments)
        for seg in current_segments:
            all_tokens.extend(seg.tokens)

        if not condition_on_previous_text or result.temperature > 0.5:
            # degenerate context is worse than none
            prompt_reset_since = len(all_tokens)

    for i, seg in enumerate(all_segments):
        seg.id = i

    return {
        # decode the full token stream once (openai): per-segment decoding
        # would corrupt multi-byte UTF-8 characters whose byte-level BPE
        # tokens straddle a segment boundary
        "text": tokenizer.decode(
            [t for t in all_tokens[len(initial_prompt_tokens):]
             if t < tokenizer.eot]),
        "segments": [seg.to_dict() for seg in all_segments],
        "language": language,
        "duration": content_duration,
    }


def _fmt_time(seconds: float) -> str:
    m, s = divmod(seconds, 60.0)
    h, m = divmod(int(m), 60)
    return f"{h:02d}:{int(m):02d}:{s:06.3f}"
