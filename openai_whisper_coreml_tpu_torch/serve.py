"""Batched serving: many audio requests through one device batch (port of
`serve.py`).

`transcribe_batch(model, audios, ServeOptions(...))` cuts every request
into 30 s windows, decodes the windows of all requests together and
reassembles one openai-schema result per request:

  * the mel of every request is computed on the model's device (the K4
    kernel on the card), one call per group of equal padded length;
  * SPECULATIVE SEEK: windows are first decoded at fixed 30 s offsets, then
    each request's seek chain is verified with `transcribe.seek_advance`
    and mis-seeked windows are re-decoded in batched repair rounds, so the
    output equals `transcribe(condition_on_previous_text=False)` at
    temperature 0;
  * two schedulers: "static" decodes fixed batches of `batch_size` windows
    with the per-window temperature ladder; "continuous" (`serve_cb.py`)
    refills finished rows mid-flight at per-row positions, and with
    `beam_size` refills K-row beam groups on the t=0 rung
    (`serve_cb_beam.py`), requeueing gate failures into the sampled engine
    for the t>0 rungs;
  * the per-window no-speech skip, the energy-VAD gate and `initial_prompt`
    on each request's first window;
  * word timestamps (`word_timestamps=True`): after the seek chains are
    verified, each request's decoded windows are encoded again in batches
    of `batch_size` and aligned by `timing.find_word_alignment_batch`,
    whichever scheduler decoded them;
  * speculative decoding when the model carries a paired draft
    (`model.draft`): under the static scheduler the draft rides the greedy
    and the sampled rungs, subject to the acceptance governor
    (`spec_governor`, `speculative.SpecGovernor`); beam rungs and the
    continuous schedulers keep the plain loop, as in JAX.

Batches are not padded to `batch_size` (JAX pads them to reuse one compiled
graph; PyTorch runs eagerly), the word-timestamp encodes included.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import speculative as spec_mod
from .config import FRAMES_PER_SECOND, HOP_LENGTH, N_FRAMES, SAMPLE_RATE
from .decoding import DecodingOptions, DecodingResult, decode
from .transcribe import Segment, seek_advance, window_segment_spans

log = logging.getLogger(__name__)


def spec_governor(model, options: "ServeOptions") -> spec_mod.SpecGovernor:
    """The model's acceptance governor, created on first use.

    Kept on the model, so the verdict persists across transcribe_batch
    calls (the HTTP worker calls once per micro-batch); setting
    `model.draft` drops it, since a new pairing is new evidence. The
    threshold is fixed at creation from the first call's options: an
    explicit `spec_fallback_threshold` is pinned, else the H100 prior at
    this batch calibrates itself from walled decodes (not under a mesh:
    walls differ between ranks, whose branches must agree)."""
    gov = getattr(model, "_spec_governor", None)
    if gov is None:
        thr = options.spec_fallback_threshold
        pinned = thr is not None or getattr(model, "mesh", None) is not None
        if thr is None:
            thr = spec_mod.break_even_tokens_per_iter(
                options.spec_k, batch=options.batch_size)
        gov = spec_mod.SpecGovernor(threshold=thr, pinned=pinned)
        model._spec_governor = gov
    return gov


@dataclasses.dataclass
class ServeOptions:
    batch_size: int = 8
    task: str = "transcribe"
    language: Optional[str] = None  # None -> per-window detection
    temperature: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    beam_size: Optional[int] = None
    patience: Optional[float] = None  # beam: keep round(K*patience) finished
    length_penalty: Optional[float] = None  # beam ranking (GNMT); None=avg-lp
    without_timestamps: bool = False
    logprob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    compression_ratio_threshold: Optional[float] = 2.4
    sample_len: Optional[int] = None
    # "static": fixed batches, each runs to its slowest window.
    # "continuous": mid-flight row refill at per-row positions (serve_cb)
    scheduler: str = "static"
    chunk_tokens: int = 32  # continuous: decode steps between refills
    refill_size: Optional[int] = None  # continuous; default batch_size // 4
    kv_dtype: str = "bf16"  # "int8": quantised cross-KV
    cache_dtype: str = "bf16"  # "int8": quantised self-attention cache
    # openai suppress_tokens semantics ("-1" = the non-speech set)
    suppress_tokens: Union[str, Sequence[int]] = "-1"
    # per-word timings on every segment (timing.py): the verified windows
    # are encoded again in batches and aligned after decoding
    word_timestamps: bool = False
    # conditions each request's FIRST window (openai initial_prompt with
    # conditioning off: batched serving never conditions on previous text)
    initial_prompt: Optional[str] = None
    # energy-VAD window gating (vad.py): windows without detected speech
    # never reach the decoder and act as a no-speech skip
    vad_filter: bool = False
    # speculative decoding with a paired draft (model.draft): proposals per
    # verify step on the static scheduler's non-beam rungs
    spec_k: int = 4
    # the acceptance governor withholds the draft while tokens/iteration
    # sit below the break-even (spec_fallback=False: the draft always
    # runs); the threshold defaults to the H100 prior at batch_size
    # (speculative.break_even_tokens_per_iter), which then calibrates
    # itself; an explicit value is pinned
    spec_fallback: bool = True
    spec_fallback_threshold: Optional[float] = None

    def __post_init__(self):
        # a scalar temperature is the one-rung ladder
        if isinstance(self.temperature, (int, float)):
            self.temperature = (float(self.temperature),)
        if self.word_timestamps and self.without_timestamps:
            raise ValueError(
                "word_timestamps requires timestamps (without_timestamps "
                "must be False)")
        if self.scheduler not in ("static", "continuous"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")


@dataclasses.dataclass
class _Window:
    request_id: int
    offset_frames: int
    mel: torch.Tensor  # (n_mels, N_FRAMES) on the model's device
    result: Optional[DecodingResult] = None


def _window_mel(mel: torch.Tensor, seek: int, content_frames: int) -> torch.Tensor:
    """One window's mel, openai pad_or_trim semantics: slice only up to the
    content end and ZERO-pad back to N_FRAMES (transcribe()'s loop does the
    same; the silence-mel columns of the padded audio are not used)."""
    size = max(0, min(N_FRAMES, content_frames - seek))
    return F.pad(mel[:, seek:seek + size], (0, N_FRAMES - size))


def _windows_for(mel: torch.Tensor, n_samples: int,
                 request_id: int) -> List[_Window]:
    content_frames = -(-n_samples // HOP_LENGTH)
    return [_Window(request_id, seek, _window_mel(mel, seek, content_frames))
            for seek in range(0, max(content_frames, 1), N_FRAMES)]


def _batched_mels(model, arrays: List[np.ndarray]) -> List[torch.Tensor]:
    """Mel spectrograms of many requests on the model's device: each request
    padded to a HOP multiple plus one 30 s window (openai), and one log-mel
    call per group of equal padded length (at most 64 requests a call)."""
    group_cap = 64
    by_len: Dict[int, List[int]] = {}
    for i, a in enumerate(arrays):
        n_ceil = -(-len(a) // HOP_LENGTH) * HOP_LENGTH
        by_len.setdefault(n_ceil + N_FRAMES * HOP_LENGTH, []).append(i)
    mels: List[Optional[torch.Tensor]] = [None] * len(arrays)
    for total, idxs in by_len.items():
        for start in range(0, len(idxs), group_cap):
            part = idxs[start:start + group_cap]
            stack = np.zeros((len(part), total), np.float32)
            for j, i in enumerate(part):
                stack[j, :len(arrays[i])] = arrays[i]
            out = model.log_mel(stack)
            for j, i in enumerate(part):
                mels[i] = out[j]
    return mels  # type: ignore[return-value]


def transcribe_batch(
    model,
    audios: Sequence[Union[np.ndarray, str]],
    options: ServeOptions = ServeOptions(),
) -> List[Dict[str, Any]]:
    """Transcribe many independent audio arrays or files at once; one
    openai-schema result dict ({"text", "segments", "language",
    "duration"}) per input.

    Under a mesh (`model.mesh`) the requests are split over the data
    groups; each model group runs the scheduler in lockstep on its share,
    and every rank returns all the results in request order."""
    from .audio import load_audio
    from .parallel.mesh import data_ways, split_over_data

    mesh = getattr(model, "mesh", None)
    if data_ways(mesh) > 1:
        audios = list(audios)
        return split_over_data(mesh, len(audios), lambda lo, hi: transcribe_batch(
            model, audios[lo:hi], options))

    arrays = [np.asarray(load_audio(a) if isinstance(a, str) else a, np.float32)
              for a in audios]
    mels = _batched_mels(model, arrays)

    def decode_round(wins: List[_Window]) -> None:
        if options.scheduler == "static":
            _decode_windows_static(model, wins, options)
            return
        from .serve_cb import ContinuousBatcher

        if options.beam_size is None:
            ContinuousBatcher(model, options).run(wins)
            return
        from .serve_cb_beam import BeamContinuousBatcher

        # beam on the t=0 rung under group-level continuous batching; gate
        # failures requeue into the sampled engine for the t>0 rungs (openai
        # ladder semantics: beam only on the greedy rung)
        retries = BeamContinuousBatcher(model, options).run(wins)
        t_rest = tuple(t for t in options.temperature if t > 0)
        if retries and t_rest:
            ContinuousBatcher(model, dataclasses.replace(
                options, temperature=t_rest, beam_size=None)).run(retries)

    # -- speculative seek ------------------------------------------------
    # openai's transcribe() advances window N+1 to where window N's LAST
    # complete segment ended, a data dependency that would serialise the
    # batch. Instead: speculate that every window advances fully (decode
    # all fixed 30 s offsets in one batched round), then verify each
    # request's seek chain with seek_advance and decode any window whose
    # true offset differs, again batched across requests, until every chain
    # is closed.
    content = [-(-len(a) // HOP_LENGTH) for a in arrays]
    ts_begin = model.cfg.timestamp_begin
    decoded: Dict[tuple, DecodingResult] = {}

    def walk(rid: int):
        """Follow request rid's seek chain; returns (chain, missing_seek),
        chain entries (seek, result, segment_size)."""
        chain, seek = [], 0
        while seek < content[rid]:
            r = decoded.get((rid, seek))
            if r is None:
                return chain, seek
            seg_size = min(N_FRAMES, content[rid] - seek)
            chain.append((seek, r, seg_size))
            if _window_skipped(r, options):
                seek += seg_size  # silence: skip, advance fully
            else:
                seek += seek_advance(r.tokens, ts_begin, seg_size)
        return chain, None

    speech_spans = None
    if options.vad_filter:
        from .vad import detect_speech

        speech_spans = [detect_speech(a) for a in arrays]

    def window_is_silent(w: _Window) -> bool:
        ws = w.offset_frames / FRAMES_PER_SECOND
        we = ws + min(N_FRAMES, content[w.request_id]
                      - w.offset_frames) / FRAMES_PER_SECOND
        return not any(s < we and e > ws for s, e in speech_spans[w.request_id])

    # a VAD-gated window acts exactly like an openai no-speech skip (full
    # advance, no segments); language="" so silence casts no language vote
    silent_result = DecodingResult(
        tokens=[], text="", language="", language_probs=None,
        avg_logprob=-10.0, no_speech_prob=1.0, temperature=0.0,
        compression_ratio=0.0)

    pending = [w for rid, a in enumerate(arrays)
               for w in _windows_for(mels[rid], len(a), rid)]
    # safety valve for degenerate streams that advance 2 frames per window
    max_extra = 16 * len(arrays) + 256
    while pending:
        to_decode = pending
        if speech_spans is not None:
            to_decode = []
            for w in pending:
                if window_is_silent(w):
                    w.result = silent_result
                else:
                    to_decode.append(w)
        if to_decode:
            decode_round(to_decode)
        for w in pending:
            decoded[(w.request_id, w.offset_frames)] = w.result
        pending = []
        for rid in range(len(arrays)):
            _, missing = walk(rid)
            if missing is not None:
                pending.append(_Window(rid, missing, _window_mel(
                    mels[rid], missing, content[rid])))
        if pending and len(decoded) > max_extra + sum(
                -(-c // N_FRAMES) for c in content):
            log.warning("speculative seek repair truncated after %d windows "
                        "(degenerate timestamps); remaining chains end early",
                        len(decoded))
            break

    return _reassemble(model, arrays, [walk(rid)[0] for rid in range(len(arrays))],
                       options, mels, content)


def _decode_windows_static(model, windows: List[_Window],
                           options: ServeOptions) -> None:
    """Fixed-size batches + the per-window temperature-fallback ladder."""
    prompt_tokens: Optional[List[int]] = None
    if options.initial_prompt:
        from .tokenizer import get_tokenizer

        tok = get_tokenizer(
            model.cfg,
            language=options.language if model.cfg.multilingual else None)
        # openai encoding rule: " " + stripped prompt text
        prompt_tokens = tok.encode(" " + options.initial_prompt.strip())
    base_opts = dict(
        task=options.task,
        language=options.language,
        beam_size=options.beam_size,
        patience=options.patience,
        length_penalty=options.length_penalty,
        without_timestamps=options.without_timestamps,
        sample_len=options.sample_len,
        kv_dtype=options.kv_dtype,
        cache_dtype=options.cache_dtype,
        suppress_tokens=options.suppress_tokens,
        spec_k=options.spec_k,
    )
    if prompt_tokens is not None and options.beam_size is not None:
        # beam search takes one shared pad/sot layout per decode call:
        # decode the prompted (offset-0) and the unprompted windows as two
        # groups with a uniform prompt each (token-identical to per-row
        # prompts)
        first = [w for w in windows if w.offset_frames == 0]
        rest = [w for w in windows if w.offset_frames != 0]
        for group, ptoks in ((first, prompt_tokens), (rest, None)):
            if group:
                _decode_window_batches(model, group, options, base_opts,
                                       ptoks, uniform=True)
        return
    _decode_window_batches(model, windows, options, base_opts, prompt_tokens)


def _decode_window_batches(model, windows: List[_Window], options: ServeOptions,
                           base_opts: dict, prompt_tokens: Optional[List[int]],
                           uniform: bool = False) -> None:
    bs = options.batch_size
    for start in range(0, len(windows), bs):
        chunk = windows[start:start + bs]
        batch_mels = torch.stack([w.mel for w in chunk])
        chunk_opts = dict(base_opts)
        if prompt_tokens is not None and uniform:
            chunk_opts["prompt"] = list(prompt_tokens)
        elif prompt_tokens is not None:
            # per-row prompts: only each request's FIRST window is
            # conditioned (transcribe(initial_prompt=...,
            # condition_on_previous_text=False))
            rows = [prompt_tokens if w.offset_frames == 0 else None
                    for w in chunk]
            if any(r is not None for r in rows):
                chunk_opts["prompt"] = rows

        results: List[Optional[DecodingResult]] = [None] * len(chunk)
        pending = list(range(len(chunk)))
        for t in options.temperature:
            if not pending:
                break
            # openai ladder semantics (as transcribe()): beam search only on
            # the greedy t=0 rung; t>0 rungs sample
            rung = dict(chunk_opts)
            if t > 0:
                rung["beam_size"] = None
            # a paired draft rides every non-beam rung: greedy rungs verify
            # by argmax agreement, sampled ones by rejection sampling
            # (decode routes best_of fan-outs to the plain loop). The
            # governor also takes the plain walls (withheld batches; beam
            # rungs publish none) for its live break-even
            paired = getattr(model, "draft", None)
            gov = (spec_governor(model, options)
                   if paired is not None and options.spec_fallback else None)
            opts = DecodingOptions(temperature=float(t), **rung)
            res = spec_mod.governed_decode(
                gov, paired if rung.get("beam_size") is None else None,
                lambda d: decode(model, batch_mels, opts, draft=d),
                sampled=float(t) > 0)
            still: List[int] = []
            for i in pending:
                if _needs_fallback(res[i], options):
                    still.append(i)
                else:
                    results[i] = res[i]
            pending = still
        for i in pending:  # every temperature failed: keep the last attempt
            results[i] = res[i]
        for w, r in zip(chunk, results):
            w.result = r


def _needs_fallback(r: DecodingResult, options) -> bool:
    """openai's quality gates: too compressible or too improbable, unless
    the window is silence (accepted, then skipped downstream)."""
    if (options.no_speech_threshold is not None
            and r.no_speech_prob > options.no_speech_threshold):
        return False
    return ((options.compression_ratio_threshold is not None
             and r.compression_ratio > options.compression_ratio_threshold)
            or (options.logprob_threshold is not None
                and r.avg_logprob < options.logprob_threshold))


def _window_skipped(r: DecodingResult, options: ServeOptions) -> bool:
    """openai no-speech skip rule (identical to transcribe())."""
    return (options.no_speech_threshold is not None
            and r.no_speech_prob > options.no_speech_threshold
            and not (options.logprob_threshold is not None
                     and r.avg_logprob > options.logprob_threshold))


def _reassemble(model, arrays, chains, options, mels: List[torch.Tensor],
                content: List[int]) -> List[Dict[str, Any]]:
    """Stitch each request's verified seek chain into one result.

    chains[rid]: ordered (seek, DecodingResult, segment_size) entries from
    the speculative-seek walk, the windows transcribe() would decode.
    mels[rid] and content[rid] (its content frames) feed the word-timestamp
    pass."""
    out: List[Dict[str, Any]] = []
    for rid, arr in enumerate(arrays):
        segs: List[Segment] = []
        align_jobs: List[tuple] = []
        language_votes: Dict[str, float] = {}
        for seek, r, seg_size in chains[rid]:
            if r.language_probs:
                for code, p in r.language_probs.items():
                    language_votes[code] = language_votes.get(code, 0.0) + p
            elif r.language:
                # continuous scheduler: the detected code without the
                # probability dict still votes
                language_votes[r.language] = language_votes.get(r.language, 0.0) + 1.0
            if _window_skipped(r, options):
                continue
            win_segs = _segments_from_result(
                model.cfg, r, seek / FRAMES_PER_SECOND, seek,
                segment_duration=seg_size / FRAMES_PER_SECOND)
            segs.extend(win_segs)
            if options.word_timestamps and win_segs:
                align_jobs.append((win_segs, seek, seg_size))
        for i, s in enumerate(segs):
            s.id = i
        language = (options.language
                    or (max(language_votes, key=language_votes.get)
                        if language_votes else "en"))
        if align_jobs:
            _align_words(model, align_jobs, mels[rid], content[rid], language,
                         options)
        out.append({
            "text": "".join(s.text for s in segs),
            "segments": [s.to_dict() for s in segs],
            "language": language,
            "duration": len(arr) / SAMPLE_RATE,
        })
    return out


def _align_words(model, align_jobs, mel: torch.Tensor, content_frames: int,
                 language: str, options: ServeOptions) -> None:
    """The word-timestamp pass of one request: its decoded windows are
    encoded again, `batch_size` at a time (the decode rounds keep no
    features), and the windows of each batch are aligned together
    (`timing.find_word_alignment_batch`: full windows share one forward per
    token bucket). The boundary heuristics, which carry the last speech
    time from window to window, run in order."""
    from .timing import add_word_timestamps_to_segments, find_word_alignment_batch
    from .tokenizer import get_tokenizer

    lang = language if model.cfg.multilingual else None
    tok = get_tokenizer(model.cfg, language=lang)
    last_speech = 0.0
    for start in range(0, len(align_jobs), options.batch_size):
        chunk = align_jobs[start:start + options.batch_size]
        feats = model.encode(torch.stack([_window_mel(mel, seek, content_frames)
                                          for _, seek, _ in chunk]))
        jobs = [([t for seg in win_segs for t in seg.tokens if t < tok.eot],
                 feats[i], seg_size)
                for i, (win_segs, _, seg_size) in enumerate(chunk)]
        aligned = find_word_alignment_batch(model, tok, jobs, language=lang)
        for i, (win_segs, seek, seg_size) in enumerate(chunk):
            if not jobs[i][0]:
                continue
            add_word_timestamps_to_segments(
                model, tok, win_segs, feats[i], num_frames=seg_size,
                time_offset=seek / FRAMES_PER_SECOND, language=lang,
                last_speech_timestamp=last_speech, timings=aligned[i])
            ends = [w["end"] for s in win_segs for w in (s.words or [])]
            if ends:  # as transcribe() carries it from window to window
                last_speech = ends[-1]


def _segments_from_result(cfg, r: DecodingResult, time_offset: float,
                          seek: int, segment_duration: float) -> List[Segment]:
    """Split one window's tokens into timestamped segments with
    transcribe()'s in-window rule: only the closed segments (plus the final
    open one when the window ends on a single trailing timestamp); the
    incomplete tail is re-decoded in the next window of the verified seek
    chain. An empty decode still yields one empty segment spanning the
    window, as in transcribe()."""
    from .tokenizer import get_tokenizer

    tok = get_tokenizer(cfg, language=r.language if cfg.multilingual else None)

    def seg(start, end, toks):
        return Segment(
            id=0, seek=seek, start=start, end=end,
            text=tok.decode([int(t) for t in toks if t < tok.eot]),
            tokens=[int(t) for t in toks], temperature=r.temperature,
            avg_logprob=r.avg_logprob, compression_ratio=r.compression_ratio,
            no_speech_prob=r.no_speech_prob)

    segs = [seg(start, end, toks) for start, end, toks in window_segment_spans(
        np.asarray(r.tokens, dtype=np.int64), cfg.timestamp_begin, time_offset,
        segment_duration)]
    # openai clears instantaneous or text-less segments
    for s in segs:
        if s.start == s.end or not s.text.strip():
            s.text = ""
            s.tokens = []
    return segs
