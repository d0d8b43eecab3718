"""Continuous batching: window-level row refill mid-flight (port of
`serve_cb.py`, greedy and sampled rows).

The static scheduler decodes fixed batches, each until its LAST window
reaches EOT, so rows that finished early sit idle. This engine keeps every
row of one device batch busy:

  * the decode loop advances PER-ROW positions (`decode_step` with a (B,)
    pos_offset) in chunks of `chunk_tokens` steps; on the card every step
    runs the K3/K6 decode kernels with per-row bounds;
  * between chunks, finished rows are harvested and refilled from the
    pending queue: windows are encoded a batch at a time into a pool of
    cross-KV (the encoder runs at full batch), and a refill group draws
    from the pool, is prefilled on its own, and is scattered into the
    free rows;
  * the temperature is per row, so temperature-fallback retries re-enter
    the queue and mix with first attempts in the same batch;
  * `run(windows, arrivals=...)` also takes an open-loop arrival source.

The JAX engine jits these pieces as fixed-shape graphs; here they are eager
PyTorch (`prefill_from_cross`, `decode_chunk`, `scatter_rows`), and groups
are not padded to a fixed size. Sampled rows draw Gumbel-max noise keyed by
(the engine's step count, the row), so they match JAX's `jax.random.split`
draws in distribution only. Greedy rows are token-exact against the static
scheduler in fp32; in bf16 the two can differ on near-tie argmaxes, as the
refill groups run the encoder and prefill at other batch sizes.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .decoding import (DecodingOptions, DecodingResult, _apply_logit_rules,
                       _detect_language_core, _prompt_bucket, build_blank_mask,
                       build_suppress_mask, compression_ratio, gumbel_noise)
from .models import decoder as dec_mod
from .tokenizer import LANGUAGES, get_tokenizer

log = logging.getLogger(__name__)


class CBState(NamedTuple):
    """Live decode state of one device batch of rows."""

    tokens: torch.Tensor  # (B, total_len) int64
    logits: torch.Tensor  # (B, V) fp32: logits for the position in `pos`
    pos: torch.Tensor  # (B,) int64: per-row next position to sample
    finished: torch.Tensor  # (B,) bool
    sum_lp: torch.Tensor  # (B,) fp32
    n_sampled: torch.Tensor  # (B,) int64
    ts_max: torch.Tensor  # (B,) int64 (ts_begin - 1 sentinel)
    temp: torch.Tensor  # (B,) fp32: per-row sampling temperature
    no_speech: torch.Tensor  # (B,) fp32: SOT-step no-speech probability
    pad: torch.Tensor  # (B,) int64: per-row left-pad, slots [0, pad) masked
    cache: Union[dec_mod.KVCache, dec_mod.QuantKVCache]
    cross_kv: Union[dec_mod.CrossKV, dec_mod.QuantCrossKV]


def prefill_from_cross(
    decoder: dec_mod.TextDecoder,
    cross_kv,  # CrossKV | QuantCrossKV, batch R
    initial_tokens: torch.Tensor,  # (R, prompt_len), left-padded
    temps: torch.Tensor,  # (R,) fp32
    pad_len: torch.Tensor,  # (R,) per-row left-pads
    sot_index: torch.Tensor,  # (R,) per-row SOT slot
    *,
    sample_len: int,
    prompt_len: int,
    cache_len: int,
    cache_dtype: str = "bf16",
) -> CBState:
    """Prompt prefill against already-encoded cross-KV (no encoder work)."""
    cfg = decoder.cfg
    dev = initial_tokens.device
    r = initial_tokens.shape[0]
    dtype = decoder.token_embedding.dtype
    cache = dec_mod.init_cache(cfg, r, dtype, dev, ctx=cache_len,
                               cache_dtype=cache_dtype, n_head=decoder.n_head)
    tokens = torch.full((r, prompt_len + sample_len), cfg.eot_token,
                        dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = initial_tokens
    prefill_logits, cache = dec_mod.decode_step(
        decoder, initial_tokens, cross_kv, cache, 0, valid_from=pad_len)
    rows = torch.arange(r, device=dev)
    no_speech = torch.softmax(prefill_logits[rows, sot_index], dim=-1)[
        :, cfg.no_speech_token]
    return CBState(
        tokens=tokens,
        logits=prefill_logits[:, -1],
        pos=torch.full((r,), prompt_len, dtype=torch.long, device=dev),
        finished=torch.zeros(r, dtype=torch.bool, device=dev),
        sum_lp=torch.zeros(r, dtype=torch.float32, device=dev),
        n_sampled=torch.zeros(r, dtype=torch.long, device=dev),
        ts_max=torch.full((r,), cfg.timestamp_begin - 1, dtype=torch.long,
                          device=dev),
        temp=temps.float(),
        no_speech=no_speech,
        pad=pad_len,
        cache=cache,
        cross_kv=cross_kv,
    )


def decode_chunk(
    decoder: dec_mod.TextDecoder,
    state: CBState,
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    max_initial_ts_index: int,
    *,
    chunk: int,
    use_timestamps: bool,
    prompt_len: int,
    total_len: int,
    sampled: bool = False,  # some row has temperature > 0
    step: int = 0,  # the engine's step count: keys the sampling noise
) -> Tuple[CBState, int]:
    """Advance every unfinished row by up to `chunk` tokens at its own
    position (early exit when all rows finish); returns (state, step).
    The token buffer and the cache are written in place."""
    cfg = decoder.cfg
    eot = cfg.eot_token
    rows = torch.arange(state.tokens.shape[0], device=state.tokens.device)
    self_kernel = dec_mod.use_self_kernel(state.cache)
    st = state
    for _ in range(chunk):
        if bool(st.finished.all()):
            break
        filtered = _apply_logit_rules(
            st.logits, st.tokens, st.pos, cfg, prompt_len, suppress_mask,
            blank_mask, use_timestamps, st.ts_max, max_initial_ts_index)
        tok = filtered.argmax(dim=-1)
        if sampled:
            noise = gumbel_noise(0, rows, step, filtered.shape[-1])
            drawn = (filtered / st.temp.clamp(min=1e-6)[:, None] + noise).argmax(dim=-1)
            tok = torch.where(st.temp > 0, drawn, tok)
        tok_lp = torch.log_softmax(filtered, dim=-1).gather(1, tok[:, None])[:, 0]
        step += 1

        tok = torch.where(st.finished, eot, tok)
        sum_lp = st.sum_lp + torch.where(st.finished, 0.0, tok_lp)
        n_sampled = st.n_sampled + (~st.finished).long()
        ts_max = torch.where((tok >= cfg.timestamp_begin) & ~st.finished, tok,
                             st.ts_max)
        # finished rows must not write: a row frozen at pos == total_len
        # would clobber the token it sampled at total_len - 1
        write_pos = st.pos.clamp(max=total_len - 1)
        tokens = st.tokens
        tokens[rows, write_pos] = torch.where(st.finished,
                                              tokens[rows, write_pos], tok)
        finished = st.finished | (tok == eot) | (st.pos + 1 >= total_len)
        next_logits, cache = dec_mod.decode_step(
            decoder, tok[:, None], st.cross_kv, st.cache, st.pos,
            valid_from=st.pad, self_kernel=self_kernel)
        st = st._replace(tokens=tokens, logits=next_logits[:, 0],
                         pos=torch.where(st.finished, st.pos, st.pos + 1),
                         finished=finished, sum_lp=sum_lp, n_sampled=n_sampled,
                         ts_max=ts_max, cache=cache)
    return st, step


def scatter_rows(state: NamedTuple, rows: NamedTuple, idx: List[int],
                 group_idx: Optional[List[int]] = None,
                 group_fields: Tuple[str, ...] = ()) -> NamedTuple:
    """Insert a refill group's rows at batch rows `idx` (in place for the
    caches and cross-KV; the per-row vectors are rebuilt). A beam state
    (`serve_cb_beam.CBBeamState`) also has per-group fields: those named in
    `group_fields` go to the group slots `group_idx`."""
    dev = state.tokens.device
    dst = torch.as_tensor(idx, device=dev)
    dst_group = None if group_idx is None else torch.as_tensor(group_idx, device=dev)

    def put(a, r, axis, where):
        if axis == 0:
            a = a.clone()
            a[where] = r
        else:
            a[:, where] = r  # the (L, B, ...) caches, in place
        return a

    fields = {}
    for name in type(state)._fields:
        a, r = getattr(state, name), getattr(rows, name)
        if name in ("cache", "cross_kv"):
            fields[name] = type(a)(*(put(x, y, 1, dst) for x, y in zip(a, r)))
        else:
            fields[name] = put(a, r, 0, dst_group if name in group_fields else dst)
    return type(state)(**fields)


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    window: Any  # serve._Window
    temp_index: int
    language: str


class ContinuousBatcher:
    """Drives one device batch of rows over a queue of 30 s windows.

        ContinuousBatcher(model, options).run(windows)  # fills w.result
    """

    def __init__(self, model, options) -> None:
        cfg = model.cfg
        self.model = model
        self.options = options
        self.cfg = cfg
        self.bs = options.batch_size
        self.refill = options.refill_size or max(1, self.bs // 4)
        self.chunk = options.chunk_tokens
        self.tokenizer = get_tokenizer(
            cfg, language=(options.language or "en") if cfg.multilingual
            else None, task=options.task)
        d_opts = DecodingOptions(task=options.task,
                                 suppress_tokens=options.suppress_tokens,
                                 without_timestamps=options.without_timestamps)
        dev = model.device
        self.suppress_mask = torch.from_numpy(
            build_suppress_mask(self.tokenizer, d_opts)).to(dev)
        self.blank_mask = torch.from_numpy(build_blank_mask(self.tokenizer)).to(dev)
        self.use_timestamps = not options.without_timestamps
        self.max_init_idx = -1 if options.without_timestamps else 50  # 1.0 s

        # prompt layout: [sot_prev, initial_prompt?] + [sot, lang, task]
        # (+notimestamps), left-padded to a shared bucket; rows without a
        # conditioning prompt (every window past a request's first) pad
        # further left, per row
        base = 3 if cfg.multilingual else 1
        if options.without_timestamps:
            base += 1
        self.prompt_tokens: Optional[List[int]] = None
        if options.initial_prompt:
            max_prompt = cfg.n_text_ctx // 2 - 1
            self.prompt_tokens = self.tokenizer.encode(
                " " + options.initial_prompt.strip())[-max_prompt:]
            self.prompt_len = _prompt_bucket(1 + len(self.prompt_tokens) + base,
                                             cfg.n_text_ctx)
        else:
            self.prompt_len = 4
        sample_len = options.sample_len or cfg.n_text_ctx // 2
        self.sample_len = min(sample_len, cfg.n_text_ctx - self.prompt_len)
        self.total_len = self.prompt_len + self.sample_len
        self.cache_len = min(-(-self.total_len // 128) * 128, cfg.n_text_ctx)
        self.temperatures = list(options.temperature)

    # -- helpers -------------------------------------------------------------

    def _temperature(self, slot: _Slot) -> float:
        return self.temperatures[min(slot.temp_index, len(self.temperatures) - 1)]

    def _initial_tokens(self, slots: List[_Slot]) -> Tuple[np.ndarray, ...]:
        """Per-row [pad | sot_prev prompt? | sot lang task ...] sequences:
        (tokens (R, prompt_len), pads (R,), sot indices (R,)). A request's
        first window carries the initial prompt when one is set."""
        tok = self.tokenizer
        out, pads, sots = [], [], []
        for s in slots:
            if self.cfg.multilingual:
                task_tok = (tok.transcribe if self.options.task == "transcribe"
                            else tok.translate)
                seq = [tok.sot, tok.language_token(s.language), task_tok]
            else:
                seq = [tok.sot]
            if self.options.without_timestamps:
                seq.append(tok.no_timestamps)
            sot_off = 0
            if self.prompt_tokens and s.window.offset_frames == 0:
                seq = [tok.sot_prev] + self.prompt_tokens + seq
                sot_off = 1 + len(self.prompt_tokens)
            pad = self.prompt_len - len(seq)
            out.append([tok.eot] * pad + seq)
            pads.append(pad)
            sots.append(pad + sot_off)
        return np.asarray(out), np.asarray(pads), np.asarray(sots)

    def _encode_pool(self, pending: deque) -> None:
        """Encode up to batch_size pending windows in one encoder call into
        the pool (cross-KV and language per window); refill groups draw
        from it without touching the encoder."""
        group = [pending.popleft() for _ in range(min(self.bs, len(pending)))]
        feats = self.model.encode(torch.stack([s.window.mel for s in group]))
        if self.options.language is not None or not self.cfg.multilingual:
            langs = [self.options.language or "en"] * len(group)
        else:
            idx, _ = _detect_language_core(self.model.decoder, feats)
            langs = [LANGUAGES[i] for i in idx.cpu().tolist()]
        for s, lang in zip(group, langs):
            s.language = lang
        self._pool_cross = dec_mod.precompute_cross(self.model.decoder, feats,
                                                    self.options.kv_dtype)
        self._pool_slots = group
        self._pool_next = 0

    def _pool_remaining(self) -> int:
        return len(self._pool_slots) - self._pool_next

    def _draw_from_pool(self, count: int) -> Tuple[CBState, List[_Slot]]:
        """Prefill the next `count` pooled windows."""
        lo = self._pool_next
        take = self._pool_slots[lo:lo + count]
        self._pool_next += len(take)
        dev = self.model.device
        cross = type(self._pool_cross)(*(t[:, lo:lo + len(take)]
                                         for t in self._pool_cross))
        initial, pads, sots = self._initial_tokens(take)
        temps = torch.tensor([self._temperature(s) for s in take],
                             dtype=torch.float32, device=dev)
        rows = prefill_from_cross(
            self.model.decoder, cross, torch.from_numpy(initial).to(dev),
            temps, torch.from_numpy(pads).to(dev), torch.from_numpy(sots).to(dev),
            sample_len=self.sample_len, prompt_len=self.prompt_len,
            cache_len=self.cache_len, cache_dtype=self.options.cache_dtype)
        return rows, take

    def _empty_state(self) -> CBState:
        """bs finished rows with zeroed caches and cross-KV: the state that
        the first refill fills."""
        cfg, dev, bs = self.cfg, self.model.device, self.bs
        dtype = self.model.decoder.token_embedding.dtype
        cross = type(self._pool_cross)(*(
            torch.zeros((t.shape[0], bs) + t.shape[2:], dtype=t.dtype, device=dev)
            for t in self._pool_cross))
        return CBState(
            tokens=torch.full((bs, self.total_len), cfg.eot_token,
                              dtype=torch.long, device=dev),
            logits=torch.zeros((bs, cfg.n_vocab), device=dev),
            pos=torch.full((bs,), self.prompt_len, dtype=torch.long, device=dev),
            finished=torch.ones(bs, dtype=torch.bool, device=dev),
            sum_lp=torch.zeros(bs, device=dev),
            n_sampled=torch.zeros(bs, dtype=torch.long, device=dev),
            ts_max=torch.full((bs,), cfg.timestamp_begin - 1, dtype=torch.long,
                              device=dev),
            temp=torch.zeros(bs, device=dev),
            no_speech=torch.zeros(bs, device=dev),
            pad=torch.zeros(bs, dtype=torch.long, device=dev),
            cache=dec_mod.init_cache(cfg, bs, dtype, dev, ctx=self.cache_len,
                                     cache_dtype=self.options.cache_dtype,
                                     n_head=self.model.decoder.n_head),
            cross_kv=cross,
        )

    def _harvest(self, host: Dict[str, np.ndarray], row: int, entry: _Slot
                 ) -> Tuple[DecodingResult, bool]:
        """The DecodingResult of a finished row from the chunk's host
        snapshot; returns (result, needs_retry)."""
        from .serve import _needs_fallback

        tok = self.tokenizer
        sampled = host["tokens"][row, self.prompt_len:]
        eot_pos = np.nonzero(sampled == tok.eot)[0]
        cut = int(eot_pos[0]) if len(eot_pos) else len(sampled)
        toks = sampled[:cut].tolist()
        text = tok.decode(toks).strip()
        result = DecodingResult(
            tokens=toks,
            text=text,
            language=entry.language,
            language_probs=None,
            avg_logprob=float(host["sum_lp"][row]) / max(int(host["n_sampled"][row]), 1),
            no_speech_prob=float(host["no_speech"][row]),
            temperature=float(self._temperature(entry)),
            compression_ratio=compression_ratio(text),
        )
        retry = (_needs_fallback(result, self.options)
                 and entry.temp_index + 1 < len(self.temperatures))
        return result, retry

    # -- main loop -----------------------------------------------------------

    def run(self, windows: List[Any],
            arrivals: Optional[Callable[[], Optional[List[Any]]]] = None) -> None:
        """Decode every window; fills w.result.

        arrivals: an optional open-loop source, a zero-argument callable
        polled between chunks that returns newly arrived windows ([] when
        none yet, None once the stream is closed); they are prefilled into
        free rows without waiting for a batch boundary.
        """
        language = self.options.language or "en"
        pending: deque = deque(_Slot(w, 0, language) for w in windows)
        closed = arrivals is None

        def poll_arrivals() -> None:
            nonlocal closed
            if closed:
                return
            got = arrivals()
            if got is None:
                closed = True
            else:
                pending.extend(_Slot(w, 0, language) for w in got)

        # wait for the first window(s), then encode one batch into the pool
        while not pending:
            poll_arrivals()
            if closed and not pending:
                return
            if not pending:
                time.sleep(0.002)
        bs = self.bs
        active: List[Optional[_Slot]] = [None] * bs
        self._encode_pool(pending)
        state = self._empty_state()

        def fill(state: CBState, free: List[int], count: int) -> CBState:
            rows, group = self._draw_from_pool(count)
            for i, s in zip(free, group):
                active[i] = s
            return scatter_rows(state, rows, free[:count])

        state = fill(state, list(range(bs)), self._pool_remaining())
        step = 0
        while True:
            poll_arrivals()
            if any(a is not None for a in active):
                sampled = any(a is not None and self._temperature(a) > 0
                              for a in active)
                state, step = decode_chunk(
                    self.model.decoder, state, self.suppress_mask,
                    self.blank_mask, self.max_init_idx, chunk=self.chunk,
                    use_timestamps=self.use_timestamps,
                    prompt_len=self.prompt_len, total_len=self.total_len,
                    sampled=sampled, step=step)

            finished = state.finished.cpu().numpy()
            done = [s for s in range(bs) if active[s] is not None and finished[s]]
            if done:
                host = {  # one snapshot per chunk, shared by every harvest
                    "tokens": state.tokens.cpu().numpy(),
                    "n_sampled": state.n_sampled.cpu().numpy(),
                    "sum_lp": state.sum_lp.cpu().numpy(),
                    "no_speech": state.no_speech.cpu().numpy(),
                }
            for s in done:
                entry = active[s]
                result, retry = self._harvest(host, s, entry)
                if retry:
                    entry.temp_index += 1
                    pending.append(entry)
                else:
                    entry.window.result = result
                active[s] = None

            free = [s for s in range(bs) if active[s] is None]
            supply = self._pool_remaining() + len(pending)
            if supply and (len(free) >= self.refill
                           or all(a is None for a in active)):
                if self._pool_remaining() == 0:
                    self._encode_pool(pending)
                count = min(self.refill, len(free), self._pool_remaining())
                log.debug("refill count=%d free=%d pending=%d pool=%d", count,
                          len(free), len(pending), self._pool_remaining())
                state = fill(state, free, count)
            if (not pending and self._pool_remaining() == 0
                    and all(a is None for a in active)):
                if closed:
                    break
                # open-loop idle: every row drained, the stream still live
                time.sleep(0.002)
