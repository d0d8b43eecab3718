"""Decoding, language ID and the logit rules (port of `decoding.py`).

Greedy, sampled (temperature > 0, with `best_of` candidates) and beam
(`beam.py`) decoding of a batch of 30 s windows with prompt prefill, the
suppress/blank/timestamp logit rules, int8 or bf16 cross-KV, no-speech
probability, per-sample prompts, language ID, and a bf16 or int8
self-attention cache (`cache_dtype`). The decode loop is the JAX package's
flat loop (`two_level=False`): its two-level staging cache works around an
XLA-TPU layout cost and gives the same tokens, so `two_level` is accepted
and has no effect here. On the card, single-token steps over a bf16 cache
run the K3 kernel (`decode_step(self_kernel=True)`), which JAX leaves off.

Sampling draws Gumbel-max noise from a counter-based integer hash of
(seed, row, absolute position, vocab id), so a sampled token is a pure
function of those, as it is in JAX (`fold_in(fold_in(key, pos), row)`);
JAX's threefry bits cannot be reproduced, so the two match in distribution
only. A draft model (`decode(draft=...)`) routes greedy and sampled rungs
through speculative decoding (`speculative.py`), as JAX routes them.

Under a (data, model) mesh (`parallel/`), `decode` and `detect_language`
pad the batch to the data axis by repeating its last row, each data group
decodes its rows, and the results are gathered onto every rank. The noise
of a sampled row is keyed by its row in the whole batch, so a sampled
decode under DP draws what the one-card decode draws.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import WhisperConfig
from .models import decoder as dec_mod
from .tokenizer import LANGUAGES, Tokenizer, get_tokenizer
from .utils.profiling import annotate, spanned

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Options / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None  # default: n_text_ctx // 2
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    # previous-context prompt: one shared prompt (str or flat token list), or
    # a PER-SAMPLE list (one str/token-list/None per batch row)
    prompt: Optional[Union[str, List[int], List[Union[str, List[int], None]]]] = None
    prefix: Optional[Union[str, List[int]]] = None  # prefix for this window
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    # "int8": quantised cross-KV; "int8" cache_dtype: quantised self-attention
    # cache. Both are dequantised inline on the CPU and inside the K6 kernel
    # on the card's single-token steps
    kv_dtype: str = "bf16"
    cache_dtype: str = "bf16"
    # the JAX package's two-level staging cache; token-identical to the
    # flat loop, which is what runs here whatever the value
    two_level: bool = True
    stage_width: int = 64
    spec_k: int = 4

    def __post_init__(self):
        if self.task not in ("transcribe", "translate"):
            raise ValueError(
                f"task must be 'transcribe' or 'translate', got {self.task!r}")
        for field in ("kv_dtype", "cache_dtype"):
            v = getattr(self, field)
            if v not in ("bf16", "int8"):
                raise ValueError(f"{field} must be 'bf16' or 'int8', got {v!r}")
        if self.stage_width < 8 or self.stage_width % 8:
            raise ValueError(f"stage_width must be a positive multiple of 8, "
                             f"got {self.stage_width}")
        if not 1 <= self.spec_k <= 16:
            raise ValueError(f"spec_k must be in [1, 16], got {self.spec_k}")


@dataclasses.dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    language: str
    language_probs: Optional[Dict[str, float]]
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# ---------------------------------------------------------------------------
# Suppress masks (host side)
# ---------------------------------------------------------------------------

def build_suppress_mask(tokenizer: Tokenizer, options: DecodingOptions) -> np.ndarray:
    """Boolean (vocab,) — True where the token must never be sampled: the
    user's ids ("-1" = the non-speech set), sot/sot_prev/sot_lm/no_speech,
    the language and task specials, and no_timestamps."""
    cfg = tokenizer.cfg
    mask = np.zeros(cfg.n_vocab, dtype=bool)

    sup = options.suppress_tokens
    ids: List[int] = []
    if isinstance(sup, str):
        ids = [int(s) for s in sup.split(",") if s] if sup else []
    elif sup is not None:
        ids = list(sup)
    if -1 in ids:
        ids = [i for i in ids if i != -1]
        ids.extend(tokenizer.non_speech_tokens)

    ids.extend([tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
                tokenizer.sot_prev, tokenizer.sot_lm])
    if tokenizer.no_speech is not None:
        ids.append(tokenizer.no_speech)
    ids.extend(range(cfg.lang_token_start, cfg.lang_token_start + cfg.n_langs))
    mask[np.asarray(sorted(set(ids)), dtype=np.int64)] = True
    mask[tokenizer.no_timestamps] = True
    return mask


def build_blank_mask(tokenizer: Tokenizer) -> np.ndarray:
    """True for ' ' encodings and EOT — suppressed at the first sampled step."""
    mask = np.zeros(tokenizer.cfg.n_vocab, dtype=bool)
    for t in tokenizer.blank_tokens:
        mask[t] = True
    mask[tokenizer.eot] = True
    return mask


# ---------------------------------------------------------------------------
# Logit rules
# ---------------------------------------------------------------------------

def _apply_logit_rules(
    logits: torch.Tensor,  # (B, V) fp32
    tokens: torch.Tensor,  # (B, L) buffer
    pos: Union[int, torch.Tensor],  # index being sampled now: int (lockstep)
    # or (B,) per row (continuous batching)
    cfg: WhisperConfig,
    prompt_len: int,
    suppress_mask: torch.Tensor,  # (V,) bool
    blank_mask: torch.Tensor,  # (V,) bool
    use_timestamps: bool,
    ts_max: torch.Tensor,  # (B,) max timestamp token sampled so far
    max_initial_ts_index: int,  # -1 disables
) -> torch.Tensor:
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    ts_begin = cfg.timestamp_begin
    rowpos = torch.is_tensor(pos)
    if rowpos:
        pos = pos[:, None]  # (B, 1); the rules below broadcast over rows
        last = tokens.gather(1, (pos - 1).clamp(min=0))
        penult = tokens.gather(1, (pos - 2).clamp(min=0))
    else:
        last = tokens[:, max(pos - 1, 0), None]
        penult = tokens[:, max(pos - 2, 0), None]
    is_first = pos == prompt_len  # bool, or (B, 1) per row
    any_first = rowpos or is_first

    logits = logits.masked_fill(suppress_mask[None, :], NEG_INF)
    if any_first:
        logits = logits.masked_fill(blank_mask[None, :] & is_first, NEG_INF)
    if not use_timestamps:
        return logits.masked_fill(vocab_ids >= ts_begin, NEG_INF)

    # openai ApplyTimestampRules
    last_is_ts = (last >= ts_begin) & (pos - 1 >= prompt_len)  # (B, 1)
    # with fewer than two sampled tokens the "penultimate" counts as a
    # timestamp, so the opening timestamp is followed by text
    penult_is_ts = (penult >= ts_begin) | (pos - 2 < prompt_len)

    # a) two timestamps in a row -> next must be text
    rule_a = last_is_ts & penult_is_ts & (vocab_ids >= ts_begin)
    # b) lone timestamp -> must pair: suppress text (eot allowed)
    rule_b = last_is_ts & ~penult_is_ts & (vocab_ids < cfg.eot_token)
    # c) non-decreasing timestamps: after a lone timestamp the pair may be
    # equal, otherwise strictly greater; ts_max starts at ts_begin - 1
    lone_ts = (last_is_ts & ~penult_is_ts)[:, 0]
    ts_last = torch.where(lone_ts, ts_max, ts_max + 1)[:, None]
    rule_c = (vocab_ids >= ts_begin) & (vocab_ids < ts_last)
    logits = logits.masked_fill(rule_a | rule_b | rule_c, NEG_INF)

    # d) the first sampled token is a timestamp, bounded by max_initial
    if any_first:
        first_rule = vocab_ids < ts_begin
        if max_initial_ts_index >= 0:
            first_rule = first_rule | (vocab_ids > ts_begin + max_initial_ts_index)
        logits = logits.masked_fill(first_rule & is_first, NEG_INF)

    # e) if the total timestamp probability outweighs the best text token,
    #    sample a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    is_ts = vocab_ids >= ts_begin
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts, NEG_INF),
                                 dim=-1, keepdim=True)
    max_text = logprobs.masked_fill(is_ts, NEG_INF).amax(dim=-1, keepdim=True)
    return logits.masked_fill((ts_logprob > max_text) & ~is_ts, NEG_INF)


# ---------------------------------------------------------------------------
# Sampling: Gumbel-max over counter-based noise
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Bijective 32-bit integer mixer on int64 tensors holding [0, 2^32);
    both multipliers are odd and below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def open_unit(bits: torch.Tensor) -> torch.Tensor:
    """32-bit integers -> fp32 uniforms in the open (0, 1): the top 23 bits
    plus one half, exact in fp32. (24 bits would round the top value up to
    1.0, whose Gumbel noise is +inf: a uniformly random token.)"""
    return ((bits >> 9).float() + 0.5) * 2.0 ** -23


def _row_keys(seed: int, rows: torch.Tensor, pos: Union[int, torch.Tensor],
              tag: Optional[int] = None) -> torch.Tensor:
    """(len(rows),) 32-bit keys of (seed, position, row[, tag]): pos is one
    int for every row or a (len(rows),) tensor of per-row positions (the
    speculative loop's rows sit at different positions). A tag splits off
    an independent stream, as JAX's `fold_in(key, tag)`; untagged keys are
    the plain loops'."""
    dev = rows.device
    if torch.is_tensor(pos):
        pos = pos.to(device=dev, dtype=torch.long)
    key = _mix32(_mix32(torch.tensor(seed & _MASK32, device=dev)) ^ (pos & _MASK32))
    row_key = _mix32(key ^ (rows.long() & _MASK32))
    if tag is not None:
        row_key = _mix32(_mix32(row_key ^ 0x68E31DA4) ^ (tag & _MASK32))
    return row_key


def gumbel_noise(seed: int, rows: torch.Tensor, pos: Union[int, torch.Tensor],
                 n_vocab: int, tag: Optional[int] = None) -> torch.Tensor:
    """(len(rows), n_vocab) standard Gumbel noise; entry [i, v] is a pure
    function of (seed, rows[i], the row's position, v[, tag]), the same on
    the CPU and the card. pos: int, or (len(rows),) per-row positions."""
    row_key = _row_keys(seed, rows, pos, tag)
    bits = _mix32(_mix32(row_key[:, None]
                         ^ torch.arange(n_vocab, device=rows.device)))
    return -torch.log(-torch.log(open_unit(bits)))


def uniform_noise(seed: int, rows: torch.Tensor, pos: Union[int, torch.Tensor],
                  tag: int) -> torch.Tensor:
    """(len(rows),) uniforms in (0, 1), one per row, from the tagged stream
    of (seed, row, position): the speculative acceptance test's draws."""
    return open_unit(_mix32(_row_keys(seed, rows, pos, tag)))


def sample_tokens(logits: torch.Tensor, temperature: float, seed: int,
                  pos: int, row0: int = 0) -> torch.Tensor:
    """One token per row of (B, V) logits: argmax at temperature 0, else a
    draw from softmax(logits / temperature) keyed by (seed, row, pos); row
    i is row row0 + i of the whole batch."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    rows = torch.arange(row0, row0 + logits.shape[0], device=logits.device)
    noise = gumbel_noise(seed, rows, pos, logits.shape[-1])
    return (logits / max(temperature, 1e-6) + noise).argmax(dim=-1)


# ---------------------------------------------------------------------------
# Greedy / sampling decode loop
# ---------------------------------------------------------------------------

def greedy_decode_core(
    decoder: dec_mod.TextDecoder,
    audio_features: torch.Tensor,  # (B, S, n_state)
    initial_tokens: torch.Tensor,  # (B, P) left-padded to the P bucket
    suppress_mask: torch.Tensor,  # (V,) bool
    blank_mask: torch.Tensor,  # (V,) bool
    max_initial_ts_index: int,  # -1 disables
    pad_len: Union[int, torch.Tensor],  # int or (B,): slots [0, pad_len) are padding
    sot_index: Union[int, torch.Tensor],  # int or (B,): slot holding the SOT token
    *,
    sample_len: int,
    use_timestamps: bool,
    prompt_len: int,
    kv_dtype: str = "bf16",
    cache_dtype: str = "bf16",
    temperature: float = 0.0,
    seed: int = 0,
    row0: int = 0,  # the batch's first row in the whole batch (the noise's row)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy (temperature 0) or sampled decode; returns (tokens
    (B, P+sample_len), sum_logprobs, n_sampled, no_speech_prob). prompt_len
    is the bucket size; the true prompt occupies slots [pad_len, prompt_len).
    Log-probs are of the filtered, untempered logits, as in JAX."""
    cfg = decoder.cfg
    dev = audio_features.device
    b = audio_features.shape[0]
    eot = cfg.eot_token
    total_len = prompt_len + sample_len

    cross_kv = dec_mod.precompute_cross(decoder, audio_features, kv_dtype)
    cache_len = min(-(-total_len // 128) * 128, cfg.n_text_ctx)
    cache = dec_mod.init_cache(cfg, b, audio_features.dtype, dev,
                               ctx=cache_len, cache_dtype=cache_dtype,
                               n_head=decoder.n_head)
    self_kernel = dec_mod.use_self_kernel(cache)
    pad_len = torch.as_tensor(pad_len, device=dev)

    initial_tokens = initial_tokens.to(device=dev, dtype=torch.long)
    tokens = torch.full((b, total_len), eot, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = initial_tokens

    prefill_logits, cache = dec_mod.decode_step(
        decoder, initial_tokens, cross_kv, cache, 0, valid_from=pad_len)
    # no-speech probability at the prompt's SOT slot (per row if prompts differ)
    si = torch.as_tensor(sot_index, device=dev).expand(b)
    sot_logits = prefill_logits[torch.arange(b, device=dev), si]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech_token]

    logits = prefill_logits[:, -1]
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    n_sampled = torch.zeros(b, dtype=torch.long, device=dev)
    ts_max = torch.full((b,), cfg.timestamp_begin - 1, dtype=torch.long,
                        device=dev)
    for pos in range(prompt_len, total_len):
        filtered = _apply_logit_rules(
            logits, tokens, pos, cfg, prompt_len, suppress_mask, blank_mask,
            use_timestamps, ts_max, max_initial_ts_index)
        tok = sample_tokens(filtered, temperature, seed, pos, row0)
        tok_lp = torch.log_softmax(filtered, dim=-1).gather(1, tok[:, None])[:, 0]

        tok = torch.where(finished, eot, tok)
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        n_sampled = n_sampled + (~finished).long()
        ts_max = torch.where((tok >= cfg.timestamp_begin) & ~finished, tok, ts_max)
        finished = finished | (tok == eot)
        tokens[:, pos] = tok

        next_logits, cache = dec_mod.decode_step(
            decoder, tok[:, None], cross_kv, cache, pos, valid_from=pad_len,
            self_kernel=self_kernel)
        logits = next_logits[:, 0]
        if bool(finished.all()):
            break
    return tokens, sum_lp, n_sampled, no_speech_prob


# ---------------------------------------------------------------------------
# Language identification
# ---------------------------------------------------------------------------

@spanned("lang_step")
def _detect_language_core(decoder: dec_mod.TextDecoder,
                          audio_features: torch.Tensor):
    cfg = decoder.cfg
    b = audio_features.shape[0]
    dev = audio_features.device
    cross_kv = dec_mod.precompute_cross_kv(decoder, audio_features)
    cache = dec_mod.init_kv_cache(cfg, b, audio_features.dtype, dev,
                                  n_head=decoder.n_head)
    sot = torch.full((b, 1), cfg.sot_token, dtype=torch.long, device=dev)
    logits, _ = dec_mod.decode_step(decoder, sot, cross_kv, cache, 0,
                                    self_kernel=dec_mod.use_self_kernel(cache))
    logits = logits[:, 0]  # (B, V) fp32

    lo, hi = cfg.lang_token_start, cfg.lang_token_start + cfg.n_langs
    vocab_ids = torch.arange(cfg.n_vocab, device=dev)[None, :]
    masked = logits.masked_fill((vocab_ids < lo) | (vocab_ids >= hi), NEG_INF)
    lang_probs = torch.softmax(masked, dim=-1)[:, lo:hi]
    return lang_probs.argmax(dim=-1), lang_probs


def _rows(x, lo: int, hi: int, n: int):
    """Rows [lo, hi) of a batch of n (a tensor or list), the last row
    repeated past n (the data-axis padding)."""
    idx = [min(i, n - 1) for i in range(lo, hi)]
    return x[idx] if torch.is_tensor(x) else [x[i] for i in idx]


def detect_language(model, mel_or_features, *, from_features: bool = False):
    """Language ID: returns (codes: List[str], probs: List[Dict[str, float]])
    from the SOT-step logits restricted to the language tokens."""
    from .parallel.mesh import data_ways, split_over_data

    cfg = model.cfg
    if not cfg.multilingual:
        raise ValueError("language detection requires a multilingual model")
    x = torch.as_tensor(mel_or_features, device=model.device)
    x = x if x.ndim == 3 else x[None]
    mesh = getattr(model, "mesh", None)
    if data_ways(mesh) > 1:
        n = x.shape[0]
        pairs = split_over_data(mesh, n, lambda lo, hi: list(zip(*detect_language(
            model, _rows(x, lo, hi, n), from_features=from_features))), pad=True)
        return [c for c, _ in pairs], [p for _, p in pairs]
    feats = x if from_features else model.encode(x)
    idx, probs = _detect_language_core(model.decoder, feats)
    with annotate("lang_results"):
        idx = idx.cpu().numpy()
        probs = probs.cpu().numpy()
        codes = [LANGUAGES[i] for i in idx]
        prob_dicts = [{LANGUAGES[j]: float(p[j]) for j in range(cfg.n_langs)}
                      for p in probs]
    return codes, prob_dicts


# ---------------------------------------------------------------------------
# Host-side decoding task (prompts, masks, then the decode core)
# ---------------------------------------------------------------------------

# Few, coarse buckets bound the number of distinct prompt shapes: 4 covers
# bare sot-sequences, 32 short prefixes, 224 conditioned long-form windows.
_PROMPT_BUCKETS = (4, 32, 224)


def _prompt_bucket(n: int, n_ctx: int) -> int:
    for b in _PROMPT_BUCKETS:
        if n <= b:
            # small-context models (tests) must not bucket past their own
            # context; n itself is pre-clamped to n_ctx - 2 by the caller
            return min(b, n_ctx - 2)
    return min(n, n_ctx - 2)


def _as_token_list(tokenizer: Tokenizer, x: Union[str, List[int], None],
                   prepend_space: bool = True) -> List[int]:
    if x is None:
        return []
    if isinstance(x, str):
        text = (" " + x.strip()) if prepend_space else x
        return tokenizer.encode(text)
    return list(x)


def rank_best_of(tokens: np.ndarray, sum_lp: np.ndarray,
                 n_sampled: np.ndarray, no_speech_prob: np.ndarray,
                 n_cand: int):
    """Keep each row's best of its n_cand consecutive candidates by average
    log-prob; the no-speech probability is the first candidate's."""
    b = tokens.shape[0] // n_cand
    tokens = tokens.reshape(b, n_cand, -1)
    sum_lp = sum_lp.reshape(b, n_cand)
    n_sampled = n_sampled.reshape(b, n_cand)
    no_speech_prob = no_speech_prob.reshape(b, n_cand)[:, 0]
    best = np.argmax(sum_lp / np.maximum(n_sampled, 1), axis=1)
    rows = np.arange(b)
    return (tokens[rows, best], sum_lp[rows, best], n_sampled[rows, best],
            no_speech_prob)


def decode(
    model,
    mel_or_features,
    options: DecodingOptions = DecodingOptions(),
    *,
    from_features: bool = False,
    tokenizer: Optional[Tokenizer] = None,
    seed: int = 0,
    draft=None,
) -> List[DecodingResult]:
    """Decode a batch of 30 s windows (mel (B, n_mels, 3000), or encoded
    features with from_features=True); one DecodingResult each. Beam search
    when options.beam_size is set at temperature 0; else greedy or sampled
    (seeded by `seed`), with options.best_of candidates per row at
    temperature > 0 ranked by average log-prob.

    draft: a smaller WhisperModel sharing the tokenizer (speculative.py,
    options.spec_k proposals per verify step). It rides greedy and sampled
    rungs; beam, best_of fan-outs and an int8 self-cache keep the plain
    loop. Every greedy or sampled call walls its decode core into
    speculative.LAST_TIMING (None for beam and best_of), and a speculative
    one sets speculative.LAST_STATS and adds to speculative.TOTALS.

    Under a mesh (`model.mesh`) the draft must be on the same mesh."""
    from .parallel.mesh import data_ways, split_over_data

    mesh = getattr(model, "mesh", None)
    if draft is not None and getattr(draft, "mesh", None) is not mesh:
        raise ValueError("the draft must be built on the target's mesh "
                         "(load_model(..., mesh=model.mesh))")
    kw = dict(from_features=from_features, tokenizer=tokenizer, seed=seed,
              draft=draft)
    if data_ways(mesh) == 1:
        return _decode_rows(model, mel_or_features, options, **kw)
    x = torch.as_tensor(mel_or_features, device=model.device)
    x = x if x.ndim == 3 else x[None]
    n = x.shape[0]
    prompt = options.prompt
    per_sample = (isinstance(prompt, (list, tuple)) and len(prompt) == n
                  and prompt and not isinstance(prompt[0], (int, np.integer)))

    def run(lo: int, hi: int) -> List[DecodingResult]:
        opts = options
        if per_sample:
            opts = dataclasses.replace(options, prompt=_rows(prompt, lo, hi, n))
        return _decode_rows(model, _rows(x, lo, hi, n), opts, row0=lo, **kw)

    return split_over_data(mesh, n, run, pad=True)


def _decode_rows(model, mel_or_features, options: DecodingOptions, *,
                 from_features: bool, tokenizer: Optional[Tokenizer], seed: int,
                 draft, row0: int = 0) -> List[DecodingResult]:
    """`decode` on the rows one data group holds (all of them without a
    mesh); row0 is their first row in the whole batch."""
    from . import speculative as spec_mod

    cfg = model.cfg
    dev = model.device
    x = torch.as_tensor(mel_or_features, device=dev)
    x = x if x.ndim == 3 else x[None]
    mel = None if from_features else x
    feats = x if from_features else model.encode(x)
    b = feats.shape[0]

    # -- language ----------------------------------------------------------
    language = options.language
    language_probs: List[Optional[Dict[str, float]]] = [None] * b
    if cfg.multilingual and language is None:
        langs, language_probs = detect_language(model, feats, from_features=True)
    else:
        langs = [language or "en"] * b

    if tokenizer is None:
        tokenizer = get_tokenizer(cfg, language=langs[0] if cfg.multilingual
                                  else None, task=options.task)

    sot_seqs = []
    for lang in langs:
        if cfg.multilingual:
            task_tok = (tokenizer.transcribe if options.task == "transcribe"
                        else tokenizer.translate)
            seq = [tokenizer.sot, tokenizer.language_token(lang), task_tok]
        else:
            seq = [tokenizer.sot]
        if options.without_timestamps:
            seq.append(tokenizer.no_timestamps)
        sot_seqs.append(seq)

    prompt_in = options.prompt
    # per-sample prompts: a list whose entries are themselves prompts
    # (str / token list / None), one per batch row; a flat list of ints is
    # one shared prompt
    per_sample_prompt = (isinstance(prompt_in, (list, tuple))
                         and len(prompt_in) > 0
                         and not isinstance(prompt_in[0], (int, np.integer)))
    if per_sample_prompt:
        if len(prompt_in) != b:
            raise ValueError(f"per-sample prompt list has {len(prompt_in)} "
                             f"entries for batch {b}")
        prompt_rows = [_as_token_list(tokenizer, p) for p in prompt_in]
    else:
        prompt_rows = [_as_token_list(tokenizer, prompt_in)] * b
    prefix_tokens = _as_token_list(tokenizer, options.prefix)

    sample_len = options.sample_len or cfg.n_text_ctx // 2
    # keep at most the trailing half-context of previous text and prefix
    max_prompt = cfg.n_text_ctx // 2 - 1
    prompt_rows = [p[-max_prompt:] if p else [] for p in prompt_rows]
    if prefix_tokens:
        prefix_tokens = prefix_tokens[-max_prompt:]

    initial = []
    max_len = cfg.n_text_ctx - 2  # leave room for >=1 sampled token + EOT
    for seq, ptoks in zip(sot_seqs, prompt_rows):
        toks = ([tokenizer.sot_prev] + ptoks if ptoks else [])
        toks = toks + seq + prefix_tokens
        if len(toks) > max_len:
            # drop the OLDEST conditioning; the sot sequence sits after it
            toks = toks[len(toks) - max_len:]
        initial.append(toks)

    # left-pad every row to one bucketed prompt length; per-row pads and sot
    # slots keep rows with different prompts in one batch
    prompt_len = _prompt_bucket(max(len(t) for t in initial), cfg.n_text_ctx)
    pads = [prompt_len - len(t) for t in initial]
    sots = [p + t.index(tokenizer.sot) for p, t in zip(pads, initial)]
    initial = [[tokenizer.eot] * p + t for p, t in zip(pads, initial)]
    sample_len = min(sample_len, cfg.n_text_ctx - prompt_len)
    if per_sample_prompt:
        pad, sot_index = torch.tensor(pads), torch.tensor(sots)
    else:
        assert all(p == pads[0] for p in pads)
        pad, sot_index = pads[0], sots[0]

    suppress_mask = torch.from_numpy(build_suppress_mask(tokenizer, options))
    blank_mask = torch.from_numpy(build_blank_mask(tokenizer)
                                  if options.suppress_blank
                                  else np.zeros(cfg.n_vocab, bool))
    max_init_idx = -1
    if options.max_initial_timestamp is not None and not options.without_timestamps:
        max_init_idx = round(options.max_initial_timestamp / 0.02)

    suppress_mask, blank_mask = suppress_mask.to(dev), blank_mask.to(dev)
    initial = torch.tensor(initial)
    core_kw = dict(use_timestamps=not options.without_timestamps,
                   prompt_len=prompt_len, kv_dtype=options.kv_dtype)
    use_beam = options.beam_size is not None and options.temperature == 0.0
    if use_beam and per_sample_prompt:
        raise ValueError(
            "per-sample prompts are supported for greedy/sampled decoding "
            "only (beam search assumes one shared pad/sot layout)")
    n_cand = (options.best_of
              if options.best_of and options.temperature > 0 else 1)
    use_draft = (draft is not None and not use_beam and n_cand == 1
                 and options.cache_dtype != "int8")
    # the governor's kinetics: the wall starts after the encoder and the
    # host's prompt work and ends once the tokens are on the host (on the
    # card an earlier end would time the launch queue, not the decode)
    t_core0 = time.perf_counter()
    if use_beam:
        from .beam import beam_decode_core, rank_sequences

        k = options.beam_size
        max_candidates = max(k, round(k * (options.patience or 1.0)))
        all_tokens, all_scores, all_lens, no_speech_prob = beam_decode_core(
            model.decoder, feats, initial, suppress_mask, blank_mask,
            max_init_idx, pad, sot_index, beam_size=k,
            max_candidates=max_candidates, sample_len=sample_len,
            cache_dtype=options.cache_dtype, **core_kw)
        best = rank_sequences(all_scores, all_lens,
                              options.length_penalty).argmax(dim=1)
        rows = torch.arange(b, device=best.device)
        tokens, sum_lp, n_sampled = (all_tokens[rows, best],
                                     all_scores[rows, best],
                                     all_lens[rows, best])
    elif use_draft:
        # greedy rungs verify by argmax agreement, sampled rungs by
        # rejection sampling, which keeps the plain sampled distribution
        spec_mod.check_pair(cfg, draft.cfg)
        feats_d = spec_mod.draft_features(model, draft, mel, feats)
        # candidate writes overshoot by up to K columns; keep them in context
        sample_len = min(sample_len,
                         cfg.n_text_ctx - prompt_len - options.spec_k - 1)
        (tokens, sum_lp, n_sampled, no_speech_prob, n_iters,
         n_drafted) = spec_mod.spec_decode_core(
            model.decoder, draft.decoder, feats, feats_d, initial,
            suppress_mask, blank_mask, max_init_idx, pad, sot_index,
            sample_len=sample_len, spec_k=options.spec_k,
            sampled=options.temperature > 0, temperature=options.temperature,
            seed=seed, row0=row0, **core_kw)
    else:
        # best_of: independent sampled candidates per row, ranked by average
        # log-prob (openai semantics; only meaningful at temperature > 0)
        if n_cand > 1:
            feats = feats.repeat_interleave(n_cand, dim=0)
            initial = initial.repeat_interleave(n_cand, dim=0)
            if per_sample_prompt:
                pad = pad.repeat_interleave(n_cand)
                sot_index = sot_index.repeat_interleave(n_cand)
        tokens, sum_lp, n_sampled, no_speech_prob = greedy_decode_core(
            model.decoder, feats, initial, suppress_mask, blank_mask,
            max_init_idx, pad, sot_index, temperature=options.temperature,
            seed=seed, row0=row0 * n_cand, sample_len=sample_len,
            cache_dtype=options.cache_dtype, **core_kw)

    tokens = tokens.cpu().numpy()
    sum_lp = sum_lp.cpu().numpy()
    n_sampled = n_sampled.cpu().numpy()
    no_speech_prob = no_speech_prob.cpu().numpy()
    wall_s = time.perf_counter() - t_core0
    path, stats = None, None
    if use_draft:
        n_iters = n_iters.cpu().numpy()
        stats = spec_mod.spec_stats(n_sampled, n_iters, n_drafted.cpu().numpy())
        path, units = "spec", int(np.max(n_iters))
    elif not use_beam and n_cand == 1:
        # the single-candidate loop, greedy or sampled: the same kinetics
        path, units = "plain", int(np.max(n_sampled))
    spec_mod.publish(stats, None if path is None else {
        "path": path, "wall_s": wall_s, "units": units, "batch": b,
        "k": options.spec_k if path == "spec" else None,
        "temperature": float(options.temperature)})
    if n_cand > 1:
        tokens, sum_lp, n_sampled, no_speech_prob = rank_best_of(
            tokens, sum_lp, n_sampled, no_speech_prob, n_cand)
    results = []
    for i in range(b):
        sampled = tokens[i, prompt_len:]
        eot_pos = np.nonzero(sampled == tokenizer.eot)[0]
        cut = int(eot_pos[0]) if len(eot_pos) else len(sampled)
        toks = sampled[:cut].tolist()
        text = tokenizer.decode(toks).strip()
        results.append(DecodingResult(
            tokens=toks,
            text=text,
            language=langs[i],
            language_probs=language_probs[i],
            avg_logprob=float(sum_lp[i] / max(int(n_sampled[i]), 1)),
            no_speech_prob=float(no_speech_prob[i]),
            temperature=float(options.temperature),
            compression_ratio=compression_ratio(text),
        ))
    return results
