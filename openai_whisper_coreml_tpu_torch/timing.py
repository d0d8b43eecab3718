"""Word-level timestamps by cross-attention alignment (port of `timing.py`).

A teacher-forced decoder pass over a window's text keeps the
cross-attention probabilities of the alignment heads; each head is
standardised per audio frame over the window's tokens, median-filtered
along the frames and averaged over the heads, and a dynamic-time-warping
path through the negative of that matrix gives each token its first frame.
Tokens are grouped into words (on spaces, or per unicode-complete piece for
languages written without them), punctuation is folded into its
neighbours, and openai's heuristics refine word and segment boundaries.

The forward is the decoder's own teacher forcing
(`models.decoder.decoder_forward` with a `visit` of each layer's
cross-attention probabilities): its causal self-attention runs the flash
kernel's causal mode (K1) on the card and the plain attention on the CPU.
Token counts are padded to `_ALIGN_BUCKETS` with eot: padded rows are
causally masked and left out of the per-frame statistics, so the result is
that of the unpadded window. The batched core folds each layer's heads
into one (B, T, S) accumulator and never holds every layer's weights.
The DTW, the splits and the heuristics run on the host in numpy, as in
JAX.

Under a model axis (`parallel/`) each rank's forward holds only its heads,
the contiguous block [r * H / m, (r + 1) * H / m) of the column-parallel
q/k/v: a rank standardises and filters its own selected heads, the
per-head sums are all-reduced over the model group (once per forward, and
once for each host-side branch of a partial window), and the total is
divided by the count of selected heads in the whole mask. A rank without
a selected head joins each sum with zeros. The heads are never gathered;
the text probabilities come from the replicated logits, so the DTW and the
heuristics run alike on every rank.
"""

from __future__ import annotations

import base64
import gzip
import json
import string
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import APPEND_PUNCTUATIONS, PREPEND_PUNCTUATIONS, WhisperConfig
from .models import decoder as dec_mod
from .tokenizer import Tokenizer

TOKENS_PER_SECOND = 50  # audio positions per second (1500 / 30 s)

# languages written without spaces: a word is a minimal unicode-complete piece
_UNICODE_SPLIT_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue"}

# token-length buckets of the alignment pass (padded with eot)
_ALIGN_BUCKETS = (32, 64, 128, 256, 512)


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def default_alignment_heads(cfg: WhisperConfig) -> np.ndarray:
    """(n_text_layer, n_text_head) bool: every head of the upper half of the
    decoder layers (openai's fallback when a model ships no heads)."""
    mask = np.zeros((cfg.n_text_layer, cfg.n_text_head), dtype=bool)
    mask[cfg.n_text_layer // 2:] = True
    return mask


def load_alignment_heads(spec, cfg: WhisperConfig) -> np.ndarray:
    """Any public alignment-heads representation as an (L, H) mask:

      * a boolean array or nested list of shape (n_text_layer, n_text_head);
      * a list of [layer, head] pairs (HF generation_config.json
        "alignment_heads", which `convert.py` carries into the checkpoint
        metadata);
      * a JSON string of either;
      * openai's base85-encoded gzip or zlib blob of the mask's bytes.
    """
    if isinstance(spec, (bytes, str)):
        s = spec.strip() if isinstance(spec, str) else spec
        text = s if isinstance(s, str) else s.decode("latin-1")
        if text.startswith(("[", "{")):
            return load_alignment_heads(json.loads(text), cfg)
        raw = base64.b85decode(text)
        try:
            data = gzip.decompress(raw)
        except OSError:
            data = zlib.decompress(raw)
        mask = np.frombuffer(data, dtype=bool).copy()
        return mask.reshape(cfg.n_text_layer, cfg.n_text_head)

    arr = np.asarray(spec)
    if arr.ndim == 2 and arr.shape == (cfg.n_text_layer, cfg.n_text_head):
        return arr.astype(bool)
    if arr.ndim == 2 and arr.shape[1] == 2:  # [layer, head] pairs
        mask = np.zeros((cfg.n_text_layer, cfg.n_text_head), dtype=bool)
        for layer, head in arr:
            mask[int(layer), int(head)] = True
        return mask
    raise ValueError(f"unrecognised alignment-heads spec shape {arr.shape}")


def _model_heads(model, alignment_heads) -> np.ndarray:
    """The heads to align with: the caller's, else the checkpoint's
    (`model.alignment_heads`), else the upper-half default."""
    if alignment_heads is None:
        alignment_heads = getattr(model, "alignment_heads", None)
    if alignment_heads is None:
        alignment_heads = default_alignment_heads(model.cfg)
    return np.asarray(alignment_heads, dtype=bool)


def _teacher_forced(model, tokens: torch.Tensor, audio_features: torch.Tensor,
                    visit: Callable[[int, torch.Tensor], None]) -> torch.Tensor:
    """The alignment forward: the decoder's teacher forcing over tokens
    (B, T), float cross K/V whatever the decode used, causal self-attention
    through the flash kernel on the card; visit(l, w) gets layer l's
    cross-attention probabilities (B, H, T, S) fp32. Returns the logits
    (B, T, vocab) fp32."""
    return dec_mod.decoder_forward(model.decoder, tokens, audio_features,
                                   flash=tokens.is_cuda, visit=visit)


def _median_filter_dev(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median filter over the last axis with reflect padding, on the
    tensor's device (the numpy `median_filter` of the same slice). The
    median is selected by an odd-even transposition network over the
    `width` shifted views: elementwise min/max only, the exact order
    statistic, and no (..., S, width) window copy."""
    if width % 2 != 1:
        raise ValueError("median filter width must be odd")
    pad = width // 2
    left = x[..., 1:pad + 1].flip(-1)
    right = x[..., -pad - 1:-1].flip(-1)
    xp = torch.cat([left, x, right], dim=-1)
    parts = [xp[..., k:k + x.shape[-1]] for k in range(width)]
    for p in range(width):
        for i in range(p % 2, width - 1, 2):
            parts[i], parts[i + 1] = (torch.minimum(parts[i], parts[i + 1]),
                                      torch.maximum(parts[i], parts[i + 1]))
    return parts[width // 2]


def _standardise(w: torch.Tensor, tmask: torch.Tensor,
                 cnt: torch.Tensor) -> torch.Tensor:
    """Per-frame standardisation over the valid tokens (axis -2): the
    population mean and variance of the rows where tmask holds."""
    mean = torch.where(tmask, w, 0.0).sum(dim=-2, keepdim=True) / cnt
    var = torch.where(tmask, (w - mean) ** 2, 0.0).sum(dim=-2, keepdim=True) / cnt
    return (w - mean) / (torch.sqrt(var) + 1e-8)


def _head_index(model, heads: np.ndarray, device) -> List[torch.Tensor]:
    """Per layer, the selected heads among this rank's: the mask cut to the
    rank's block of heads under a model axis."""
    axis = model.decoder.axis
    if axis is not None:
        n = heads.shape[1] // axis.size
        heads = heads[:, axis.rank * n:(axis.rank + 1) * n]
    return [torch.as_tensor(np.nonzero(row)[0], device=device) for row in heads]


def _sum_over_model(model, x: torch.Tensor) -> torch.Tensor:
    """The model group's sum of each rank's fp32 per-head sums, in place
    (x itself without a model axis)."""
    axis = model.decoder.axis
    if axis is not None:
        dist.all_reduce(x, group=axis.group)
    return x


def _host_head_mean(model, per_head: np.ndarray, n_sel: int) -> np.ndarray:
    """The mean over every rank's selected heads of a host array whose axis
    0 holds this rank's (numpy's mean: the sum, then one division)."""
    total = per_head.sum(axis=0)
    if model.decoder.axis is not None:
        t = _sum_over_model(model, torch.from_numpy(total).to(model.device))
        total = t.cpu().numpy()
    return total / n_sel


def _alignment_core(model, tokens: torch.Tensor, audio_features: torch.Tensor,
                    heads: np.ndarray, t_valid: int, gather_pos: torch.Tensor,
                    gather_ids: torch.Tensor, medfilt_width: int):
    """One window (tokens (1, T_bucket)): (text probabilities (T_bucket,),
    matrix (T_bucket, S), standardised selected heads (n_sel, T_bucket, S)
    for the host's tail fix). Heads are taken in (layer, head) order."""
    dev = tokens.device
    t = tokens.shape[1]
    index = _head_index(model, heads, dev)
    sel_parts: List[torch.Tensor] = []

    def visit(l, w):
        if index[l].numel():
            sel_parts.append(w[0, index[l]])

    logits = _teacher_forced(model, tokens, audio_features, visit)
    probs = torch.softmax(logits[0], dim=-1)
    text_probs = probs[gather_pos, gather_ids]
    sel = (torch.cat(sel_parts) if sel_parts else
           torch.zeros((0, t, audio_features.shape[1]), device=dev))
    tmask = (torch.arange(t, device=dev) < t_valid)[None, :, None]
    cnt = torch.full((1, 1, 1), float(max(t_valid, 1)), device=dev)
    sel = _standardise(sel, tmask, cnt)
    matrix = _sum_over_model(
        model, _median_filter_dev(sel, medfilt_width).sum(dim=0))
    return text_probs, matrix / max(1, int(heads.sum())), sel


def _alignment_core_batch(model, tokens: torch.Tensor,
                          audio_features: torch.Tensor, heads: np.ndarray,
                          t_valid: torch.Tensor, gather_pos: torch.Tensor,
                          gather_ids: torch.Tensor, medfilt_width: int):
    """Full windows, tokens (B, T_bucket): (text probabilities
    (B, T_bucket), matrix (B, T_bucket, S)). Each layer's selected heads are
    standardised, filtered and summed into one (B, T, S) fp32 accumulator
    as the layer is reached: the peak is one layer's (B, H, T, S)
    probabilities and the filter's temporaries. Under a model axis the
    accumulator is summed over the group once, after the forward."""
    dev = tokens.device
    b, t = tokens.shape
    index = _head_index(model, heads, dev)
    tmask = (torch.arange(t, device=dev)[None, :] < t_valid[:, None])[:, None, :, None]
    cnt = t_valid.clamp(min=1).float()[:, None, None, None]
    acc = torch.zeros((b, t, audio_features.shape[1]), dtype=torch.float32,
                      device=dev)

    def visit(l, w):
        if not index[l].numel():
            return
        if index[l].numel() < w.shape[1]:
            w = w[:, index[l]]
        acc.add_(_median_filter_dev(_standardise(w, tmask, cnt),
                                    medfilt_width).sum(dim=1))

    logits = _teacher_forced(model, tokens, audio_features, visit)
    probs = torch.softmax(logits, dim=-1)
    rows = torch.arange(b, device=dev)[:, None]
    text_probs = probs[rows, gather_pos, gather_ids]
    n_sel = torch.full((1, 1, 1), float(max(1, int(heads.sum()))), device=dev)
    return text_probs, _sum_over_model(model, acc) / n_sel


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis (reflect padding), numpy."""
    if width <= 1 or x.shape[-1] <= width:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path of least total cost through cost
    (n_tokens, n_frames): (token_indices, frame_indices).

    An anti-diagonal sweep: each cell on i + j == k depends only on
    diagonals k - 1 and k - 2, so the table fills in n + m vector steps.
    Ties go to the diagonal, then to a token advance."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for k in range(2, n + m + 1):
        i = np.arange(max(1, k - m), min(n, k - 1) + 1)
        if i.size == 0:
            continue
        j = k - i
        c0 = acc[i - 1, j - 1]  # match (diagonal)
        c1 = acc[i - 1, j]  # token advance
        c2 = acc[i, j - 1]  # frame advance
        best = np.where((c0 <= c1) & (c0 <= c2), 0,
                        np.where(c1 <= c2, 1, 2)).astype(np.int8)
        acc[i, j] = np.choose(best, (c0, c1, c2)) + cost[i - 1, j - 1]
        trace[i, j] = best
    i, j = n, m
    ti, fi = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        step = trace[i, j]
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


def split_tokens_on_unicode(tokenizer: Tokenizer, tokens: Sequence[int]
                            ) -> Tuple[List[str], List[List[int]]]:
    """Group tokens into minimal unicode-complete pieces. A byte-level BPE
    token can end inside a UTF-8 sequence; tokens accumulate until their
    joint decode is clean, and a piece with a replacement character is
    accepted only where the full text has one at that offset (openai)."""
    text_toks = [int(t) for t in tokens if int(t) < tokenizer.eot]
    full = tokenizer.decode(text_toks)
    pieces: List[str] = []
    groups: List[List[int]] = []
    cur: List[int] = []
    offset = 0
    for tok in text_toks:
        cur.append(tok)
        piece = tokenizer.decode(cur)
        rc = piece.find("�")
        if rc == -1 or (offset + rc < len(full)
                        and full[offset + rc] == "�"):
            pieces.append(piece)
            groups.append(cur)
            offset += len(piece)
            cur = []
    if cur:  # trailing incomplete bytes: what decodes
        pieces.append(tokenizer.decode(cur))
        groups.append(cur)
    return pieces, groups


def split_tokens_on_spaces(tokenizer: Tokenizer, tokens: Sequence[int]
                           ) -> Tuple[List[str], List[List[int]]]:
    """Group text tokens into words on leading spaces; a piece that is one
    ASCII punctuation character is a word of its own (merge_punctuations
    attaches it later)."""
    words: List[str] = []
    word_tokens: List[List[int]] = []
    for piece, toks in zip(*split_tokens_on_unicode(tokenizer, tokens)):
        is_punct = piece.strip() in string.punctuation
        if piece.startswith(" ") or is_punct or not words:
            words.append(piece)
            word_tokens.append(list(toks))
        else:
            words[-1] += piece
            word_tokens[-1].extend(toks)
    return words, word_tokens


def split_to_word_tokens(tokenizer: Tokenizer, tokens: Sequence[int],
                         language: Optional[str] = None
                         ) -> Tuple[List[str], List[List[int]]]:
    """Unicode pieces for zh, ja, th, lo, my and yue; spaces otherwise."""
    if language in _UNICODE_SPLIT_LANGUAGES:
        return split_tokens_on_unicode(tokenizer, tokens)
    return split_tokens_on_spaces(tokenizer, tokens)


def merge_punctuations(timings: List[WordTiming], prepended: str,
                       appended: str) -> None:
    """Fold punctuation-only words into their neighbours, in place: a word
    of a space and a `prepended` character joins the next word, an
    `appended` word without a space joins the previous one. Absorbed
    entries keep their slot, emptied, so token counts stay aligned."""
    follow = len(timings) - 1
    for i in range(len(timings) - 2, -1, -1):
        cur = timings[i]
        if cur.word.startswith(" ") and cur.word.strip() in prepended:
            nxt = timings[follow]
            nxt.word = cur.word + nxt.word
            nxt.tokens = cur.tokens + nxt.tokens
            cur.word, cur.tokens = "", []
        else:
            follow = i
    prev = 0
    for j in range(1, len(timings)):
        cur = timings[j]
        before = timings[prev]
        if not before.word.endswith(" ") and cur.word in appended:
            before.word = before.word + cur.word
            before.tokens = before.tokens + cur.tokens
            cur.word, cur.tokens = "", []
        else:
            prev = j


def _features(model, audio_features) -> torch.Tensor:
    """(1 or B, S, n_state) features on the model's device, in its dtype."""
    dtype = model.decoder.token_embedding.dtype
    feats = torch.as_tensor(audio_features, device=model.device).to(dtype)
    return feats[None] if feats.ndim == 2 else feats


def find_word_alignment(
    model,
    tokenizer: Tokenizer,
    text_tokens: Sequence[int],
    audio_features,  # (1, S, n_state) or (S, n_state)
    num_frames: int,  # mel frames of real (unpadded) audio in this window
    *,
    medfilt_width: int = 7,
    alignment_heads: Optional[np.ndarray] = None,
    language: Optional[str] = None,
) -> List[WordTiming]:
    """Align one window's text tokens to time: per-word timings."""
    feats = _features(model, audio_features)
    sot_seq = list(tokenizer.sot_sequence_including_notimestamps)
    tokens = [*sot_seq, *[int(t) for t in text_tokens], tokenizer.eot]
    text_start = len(sot_seq)
    heads = _model_heads(model, alignment_heads)

    n_audio = max(1, num_frames // 2)
    pad_w = medfilt_width // 2
    t_real = len(tokens)
    bucket = next((b for b in _ALIGN_BUCKETS if b >= t_real), t_real)
    toks_b = np.full((1, bucket), tokenizer.eot, np.int64)
    toks_b[0, :t_real] = tokens
    n_text = len(text_tokens)
    gather_pos = np.clip(text_start - 1 + np.arange(bucket), 0, bucket - 1)
    gather_ids = np.zeros((bucket,), np.int64)
    gather_ids[:n_text] = np.asarray(text_tokens, np.int64)

    dev = feats.device
    probs_d, matrix_d, sel_d = _alignment_core(
        model, torch.as_tensor(toks_b, device=dev), feats, heads, t_real,
        torch.as_tensor(gather_pos, device=dev),
        torch.as_tensor(gather_ids, device=dev), medfilt_width)
    text_probs = probs_d[:n_text].tolist()
    matrix = matrix_d[:t_real, :n_audio].cpu().numpy()

    s_full = matrix_d.shape[-1]
    n_sel = max(1, int(heads.sum()))
    if n_audio <= medfilt_width:
        # a window of 0.15 s or less: the host reference's median_filter
        # passes slices no wider than the filter through unfiltered, so the
        # matrix is the head mean of the standardised heads
        matrix = _host_head_mean(model, sel_d[:, :, :n_audio].cpu().numpy(),
                                 n_sel)[:t_real]
    elif n_audio < s_full:
        # the device filter reflects at S, the window ends at n_audio: the
        # last pad_w columns are filtered again on the host from a tail of
        # 2 * width columns, reflecting at n_audio
        lo = n_audio - min(2 * medfilt_width, n_audio)
        tail = sel_d[:, :, lo:n_audio].cpu().numpy()
        tail_f = _host_head_mean(model, median_filter(tail, medfilt_width), n_sel)
        matrix[:, n_audio - pad_w:n_audio] = tail_f[:t_real, -pad_w:]

    # the text rows only: no sot prompt, no final eot
    matrix = matrix[text_start:text_start + n_text]
    return _timings_from_matrix(tokenizer, text_tokens, text_probs, matrix,
                                language)


def _timings_from_matrix(tokenizer: Tokenizer, text_tokens: Sequence[int],
                         text_probs: Sequence[float], matrix: np.ndarray,
                         language: Optional[str]) -> List[WordTiming]:
    """DTW over the text rows' matrix, token boundaries, words."""
    if matrix.size == 0:
        return []

    ti, fi = dtw_path(-matrix)

    # a token starts at the first frame the path gives it
    jumps = np.diff(ti, prepend=-1) > 0
    token_start_frames = fi[jumps]
    token_end_frames = np.append(token_start_frames[1:], fi[-1] + 1)

    words, word_tokens = split_to_word_tokens(tokenizer, text_tokens, language)
    timings: List[WordTiming] = []
    cursor = 0
    for word, toks in zip(words, word_tokens):
        n_tok = len(toks)
        start_f = token_start_frames[min(cursor, len(token_start_frames) - 1)]
        end_f = token_end_frames[
            min(cursor + n_tok - 1, len(token_end_frames) - 1)]
        tok_probs = text_probs[cursor:cursor + n_tok]
        timings.append(WordTiming(
            word=word,
            tokens=toks,
            start=round(float(start_f) / TOKENS_PER_SECOND, 3),
            end=round(float(end_f) / TOKENS_PER_SECOND, 3),
            probability=float(np.mean(tok_probs)) if tok_probs else 0.0,
        ))
        cursor += n_tok
    return timings


def find_word_alignment_batch(
    model,
    tokenizer: Tokenizer,
    jobs: Sequence[Tuple[Sequence[int], object, int]],
    *,
    medfilt_width: int = 7,
    alignment_heads: Optional[np.ndarray] = None,
    language: Optional[str] = None,
) -> List[List[WordTiming]]:
    """Align many windows; jobs are (text_tokens, features (S, n_state),
    num_frames). One WordTiming list per job.

    Full windows (num_frames covering the whole context) share one
    forward per token bucket; partial windows go through
    find_word_alignment, whose host tail fix they need. The times equal
    the single path's."""
    s_full = model.cfg.n_audio_ctx
    results: List[Optional[List[WordTiming]]] = [None] * len(jobs)
    sot_seq = list(tokenizer.sot_sequence_including_notimestamps)
    text_start = len(sot_seq)
    heads = _model_heads(model, alignment_heads)

    by_bucket: dict = {}
    for idx, (text_tokens, feats, num_frames) in enumerate(jobs):
        n_audio = max(1, num_frames // 2)
        if not text_tokens:
            results[idx] = []
        elif n_audio < s_full or n_audio <= medfilt_width:
            results[idx] = find_word_alignment(
                model, tokenizer, text_tokens, feats, num_frames,
                medfilt_width=medfilt_width, alignment_heads=heads,
                language=language)
        else:
            t_real = text_start + len(text_tokens) + 1
            bucket = next((b for b in _ALIGN_BUCKETS if b >= t_real), t_real)
            by_bucket.setdefault(bucket, []).append(idx)

    for bucket, idxs in by_bucket.items():
        b = len(idxs)
        toks_b = np.full((b, bucket), tokenizer.eot, np.int64)
        t_valid = np.zeros((b,), np.int64)
        gather_ids = np.zeros((b, bucket), np.int64)
        for r, idx in enumerate(idxs):
            text_tokens = jobs[idx][0]
            row = [*sot_seq, *[int(t) for t in text_tokens], tokenizer.eot]
            toks_b[r, :len(row)] = row
            t_valid[r] = len(row)
            gather_ids[r, :len(text_tokens)] = np.asarray(text_tokens, np.int64)
        gather_pos = np.tile(
            np.clip(text_start - 1 + np.arange(bucket), 0, bucket - 1), (b, 1))
        feats_b = torch.cat([_features(model, jobs[idx][1]) for idx in idxs])
        dev = feats_b.device
        probs_d, matrix_d = _alignment_core_batch(
            model, torch.as_tensor(toks_b, device=dev), feats_b, heads,
            torch.as_tensor(t_valid, device=dev),
            torch.as_tensor(gather_pos, device=dev),
            torch.as_tensor(gather_ids, device=dev), medfilt_width)
        probs_h = probs_d.cpu().numpy()
        matrix_h = matrix_d.cpu().numpy()  # one copy for the bucket

        for r, idx in enumerate(idxs):
            text_tokens = jobs[idx][0]
            n_text = len(text_tokens)
            matrix = matrix_h[r, text_start:text_start + n_text, :s_full]
            results[idx] = _timings_from_matrix(
                tokenizer, text_tokens, [float(p) for p in probs_h[r, :n_text]],
                matrix, language)

    return results  # type: ignore[return-value]


_SENTENCE_END_MARKS = ".。!！?？"


def add_word_timestamps_to_segments(
    model,
    tokenizer: Tokenizer,
    segments: List,  # transcribe.Segment of one window
    audio_features,
    num_frames: int,
    time_offset: float,
    *,
    language: Optional[str] = None,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    last_speech_timestamp: float = 0.0,
    timings: Optional[List[WordTiming]] = None,
) -> None:
    """Attach .words to each segment of a window, in place, and refine word
    and segment boundaries with openai's heuristics:

      * a word longer than twice the (0.7 s-capped) median word duration
        is cut at a sentence boundary;
      * punctuation from the prepend/append sets joins its neighbours;
      * an overlong first word after more than four medians of silence is
        clipped;
      * a segment's start and end snap to its first and last words, unless
        the word is stretched past the segment, which then bounds the word.

    `last_speech_timestamp`: the absolute end of the previous window's
    speech. `timings`: this window's alignment when the caller computed it
    (find_word_alignment_batch); the heuristics mutate its entries.
    """
    text_tokens = [t for seg in segments for t in seg.tokens
                   if t < tokenizer.eot]
    if not text_tokens:
        return
    if timings is None:
        timings = find_word_alignment(model, tokenizer, text_tokens,
                                      audio_features, num_frames,
                                      language=language)

    durations = [t.end - t.start for t in timings if t.end > t.start]
    median_duration = (min(0.7, float(np.median(durations)))
                       if durations else 0.0)
    max_duration = 2.0 * median_duration
    if durations:
        # truncate implausibly long words at a sentence boundary
        for prev_t, cur_t in zip(timings, timings[1:]):
            if cur_t.end - cur_t.start > max_duration:
                if cur_t.word in _SENTENCE_END_MARKS:
                    cur_t.end = cur_t.start + max_duration
                elif prev_t.word in _SENTENCE_END_MARKS:
                    cur_t.start = cur_t.end - max_duration

    merge_punctuations(timings, prepend_punctuations, append_punctuations)

    idx = 0
    for seg in segments:
        seg_n = sum(1 for t in seg.tokens if t < tokenizer.eot)
        words = []
        consumed = 0
        while idx < len(timings) and consumed < seg_n:
            wt = timings[idx]
            if wt.word:  # slots emptied by merge_punctuations stay
                words.append({
                    "word": wt.word,
                    "start": round(time_offset + wt.start, 3),
                    "end": round(time_offset + wt.end, 3),
                    "probability": wt.probability,
                })
            consumed += len(wt.tokens)
            idx += 1
        if words:
            w0, w1 = words[0], words[1] if len(words) > 1 else None
            # an overlong first word right after a long silence is an
            # alignment artifact: clip it to max_duration
            if (w0["end"] - last_speech_timestamp > median_duration * 4
                    and (w0["end"] - w0["start"] > max_duration
                         or (w1 is not None
                             and w1["end"] - w0["start"] > max_duration * 2))):
                if w1 is not None and w1["end"] - w1["start"] > max_duration:
                    boundary = round(
                        max(w1["end"] / 2, w1["end"] - max_duration), 3)
                    w0["end"] = w1["start"] = boundary
                w0["start"] = round(max(0.0, w0["end"] - max_duration), 3)
            # the segment's start wins over a stretched first word; else the
            # word's start becomes the segment's
            if seg.start < w0["end"] and seg.start - 0.5 > w0["start"]:
                w0["start"] = round(
                    max(0.0, min(w0["end"] - median_duration, seg.start)), 3)
            else:
                seg.start = w0["start"]
            wl = words[-1]
            if seg.end > wl["start"] and seg.end + 0.5 < wl["end"]:
                wl["end"] = round(
                    max(wl["start"] + median_duration, seg.end), 3)
            else:
                seg.end = wl["end"]
            last_speech_timestamp = seg.end
        seg.words = words
