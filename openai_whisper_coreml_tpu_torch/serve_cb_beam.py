"""Continuous batching for beam search: group-level slot refill mid-flight
(port of `serve_cb_beam.py`).

Beam search is lockstep within a request: its K beam rows share one
position. So the sampled engine's per-row positions (`serve_cb`) lift to
per-GROUP positions: each slot of the device batch is a group of K adjacent
rows, groups decode at their own positions, and finished groups are
harvested and refilled mid-flight like the sampled engine's rows.

What differs from the sampled engine:
  * the chunk loop runs `beam.beam_step`, the step of
    `beam.beam_decode_core` (top-2K merge, the EOT candidate buffer, the
    within-group cache gather), with a (G,) position vector and a (G,)
    finished mask: finished groups gather with the identity permutation and
    their token writes are gated; each group stops on its own;
  * the whole right-sized cache is gathered every step (`gather_cache`),
    bf16 or int8 (JAX's engine takes a bf16 cache only; the port's gather
    handles both);
  * beam runs only on the t=0 rung: windows whose quality gates fail are
    returned, and `serve.transcribe_batch` requeues them into the sampled
    `ContinuousBatcher` for the t>0 rungs.

On the card every single-token step runs K3 (bf16 cache) or K6 (int8
cross-KV, int8 cache) with per-row bounds: a group's K rows share one
position, so the bounds are per row, repeated per group. Groups are not
padded to a fixed size (the JAX engine pads them to reuse compiled
graphs). Token-exact against the static beam path at fp32.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .beam import BeamState, beam_step, rank_sequences
from .decoding import NEG_INF, DecodingResult, compression_ratio
from .models import decoder as dec_mod
from .serve_cb import ContinuousBatcher, _Slot, scatter_rows


# the live state of G groups x K rows (JAX's name for it)
CBBeamState = BeamState


# fields indexed by group rather than by row
GROUP_FIELDS = ("pos", "finished", "no_speech", "fin_scores", "fin_tokens", "fin_lens")


def prefill_beam_from_cross(
    decoder: dec_mod.TextDecoder,
    cross_kv,  # G*K rows: each window's cross-KV repeated K-fold
    initial_tokens: torch.Tensor,  # (G*K, prompt_len)
    pad_len: torch.Tensor,  # (G*K,)
    sot_index: torch.Tensor,  # (G*K,)
    *,
    sample_len: int,
    prompt_len: int,
    cache_len: int,
    beam_size: int,
    max_candidates: int,
    cache_dtype: str = "bf16",
) -> CBBeamState:
    """Prompt prefill of G groups against already-encoded cross-KV."""
    cfg = decoder.cfg
    dev = initial_tokens.device
    gk = initial_tokens.shape[0]
    g = gk // beam_size
    eot = cfg.eot_token
    total_len = prompt_len + sample_len
    cache = dec_mod.init_cache(cfg, gk, decoder.token_embedding.dtype, dev,
                               ctx=cache_len, cache_dtype=cache_dtype,
                               n_head=decoder.n_head)
    tokens = torch.full((gk, total_len), eot, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = initial_tokens
    prefill_logits, cache = dec_mod.decode_step(
        decoder, initial_tokens, cross_kv, cache, 0, valid_from=pad_len)
    rows = torch.arange(gk, device=dev)
    no_speech = torch.softmax(prefill_logits[rows, sot_index], dim=-1)[
        :, cfg.no_speech_token]
    return CBBeamState(
        tokens=tokens,
        logits=prefill_logits[:, -1],
        sum_lp=torch.zeros(gk, device=dev),
        seq_len=torch.zeros(gk, dtype=torch.long, device=dev),
        ts_max=torch.full((gk,), cfg.timestamp_begin - 1, dtype=torch.long,
                          device=dev),
        pad=pad_len,
        pos=torch.full((g,), prompt_len, dtype=torch.long, device=dev),
        finished=torch.zeros(g, dtype=torch.bool, device=dev),
        no_speech=no_speech.reshape(g, beam_size)[:, 0],
        fin_scores=torch.full((g, max_candidates), NEG_INF, device=dev),
        fin_tokens=torch.full((g, max_candidates, total_len), eot,
                              dtype=torch.long, device=dev),
        fin_lens=torch.zeros((g, max_candidates), dtype=torch.long, device=dev),
        cache=cache,
        cross_kv=cross_kv,
    )


def beam_decode_chunk(
    decoder: dec_mod.TextDecoder,
    state: CBBeamState,
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    max_initial_ts_index: int,
    *,
    chunk: int,
    use_timestamps: bool,
    prompt_len: int,
    total_len: int,
    beam_size: int,
    max_candidates: int,
) -> CBBeamState:
    """Advance every unfinished GROUP by up to `chunk` beam steps (early
    exit when all groups finish)."""
    self_kernel = dec_mod.use_self_kernel(state.cache)
    st = state
    for _ in range(chunk):
        if bool(st.finished.all()):
            break
        st, new_scores = beam_step(
            decoder, st, suppress_mask, blank_mask, max_initial_ts_index,
            use_timestamps=use_timestamps, prompt_len=prompt_len,
            beam_size=beam_size, max_candidates=max_candidates,
            self_kernel=self_kernel)
        # per-group stop: the horizon, or no alive beam can beat the worst
        # kept finished candidate (beam_decode_core's early exit)
        improvable = new_scores.amax(dim=1) > st.fin_scores.amin(dim=1)
        st = st._replace(
            finished=st.finished | (st.pos + 1 >= total_len) | ~improvable,
            pos=torch.where(st.finished, st.pos, st.pos + 1))
    return st


def scatter_beam_rows(state: CBBeamState, rows: CBBeamState, group_idx: List[int],
                      *, beam_size: int) -> CBBeamState:
    """Insert a refill's request groups at group slots `group_idx`."""
    row_idx = [gi * beam_size + j for gi in group_idx for j in range(beam_size)]
    return scatter_rows(state, rows, row_idx, group_idx=group_idx,
                        group_fields=GROUP_FIELDS)


class BeamContinuousBatcher(ContinuousBatcher):
    """Beam-search continuous batching: slots are K-row request groups.

    Reuses the sampled engine's pool (full-batch encode into cross-KV,
    language detection, the prompt layout) and overrides the prefill, the
    chunk loop and the harvest with their group forms. Runs the t=0 rung
    only; `run` returns the windows that fail the quality gates.
    """

    def __init__(self, model, options) -> None:
        super().__init__(model, options)
        if not options.beam_size:
            raise ValueError("BeamContinuousBatcher requires beam_size")
        self.k = int(options.beam_size)
        self.max_candidates = max(self.k, round(self.k * (options.patience or 1.0)))

    # -- group prefill -------------------------------------------------------

    def _draw_from_pool(self, count: int) -> Tuple[CBBeamState, List[_Slot]]:
        """Prefill the next `count` pooled windows, K rows each."""
        lo = self._pool_next
        take = self._pool_slots[lo:lo + count]
        self._pool_next += len(take)
        dev = self.model.device
        k = self.k
        cross = type(self._pool_cross)(*(t[:, lo:lo + len(take)].repeat_interleave(k, dim=1)
                                         for t in self._pool_cross))
        initial, pads, sots = (torch.from_numpy(np.repeat(a, k, axis=0)).to(dev)
                               for a in self._initial_tokens(take))
        rows = prefill_beam_from_cross(
            self.model.decoder, cross, initial, pads, sots,
            sample_len=self.sample_len, prompt_len=self.prompt_len,
            cache_len=self.cache_len, beam_size=k,
            max_candidates=self.max_candidates, cache_dtype=self.options.cache_dtype)
        return rows, take

    def _empty_beam_state(self) -> CBBeamState:
        """bs finished groups with zeroed caches and cross-KV: the state
        that the first refill fills."""
        cfg, dev = self.cfg, self.model.device
        g, gk, c = self.bs, self.bs * self.k, self.max_candidates
        eot = cfg.eot_token
        cross = type(self._pool_cross)(*(
            torch.zeros((t.shape[0], gk) + t.shape[2:], dtype=t.dtype, device=dev)
            for t in self._pool_cross))
        return CBBeamState(
            tokens=torch.full((gk, self.total_len), eot, dtype=torch.long, device=dev),
            logits=torch.zeros((gk, cfg.n_vocab), device=dev),
            sum_lp=torch.zeros(gk, device=dev),
            seq_len=torch.zeros(gk, dtype=torch.long, device=dev),
            ts_max=torch.full((gk,), cfg.timestamp_begin - 1, dtype=torch.long,
                              device=dev),
            pad=torch.zeros(gk, dtype=torch.long, device=dev),
            pos=torch.full((g,), self.prompt_len, dtype=torch.long, device=dev),
            finished=torch.ones(g, dtype=torch.bool, device=dev),
            no_speech=torch.zeros(g, device=dev),
            fin_scores=torch.full((g, c), NEG_INF, device=dev),
            fin_tokens=torch.full((g, c, self.total_len), eot, dtype=torch.long,
                                  device=dev),
            fin_lens=torch.zeros((g, c), dtype=torch.long, device=dev),
            cache=dec_mod.init_cache(cfg, gk, self.model.decoder.token_embedding.dtype,
                                     dev, ctx=self.cache_len,
                                     cache_dtype=self.options.cache_dtype,
                                     n_head=self.model.decoder.n_head),
            cross_kv=cross,
        )

    # -- harvest (finalize and rank, on the host) ----------------------------

    def _harvest_group(self, host: Dict[str, np.ndarray], slot: int, entry: _Slot
                       ) -> Tuple[DecodingResult, bool]:
        """The DecodingResult of a finished group (beam_decode_core's
        finalize: the still-alive beams, EOT appended while the horizon
        remains, compete with the finished candidates); returns (result,
        needs_retry)."""
        from .serve import _needs_fallback

        tok = self.tokenizer
        k = self.k
        pos = int(host["pos"][slot])
        alive = slice(slot * k, (slot + 1) * k)
        alive_tokens = host["tokens"][alive].copy()
        if pos < self.total_len:
            alive_tokens[:, pos] = tok.eot
        scores = np.concatenate([host["fin_scores"][slot], host["sum_lp"][alive]])
        tokens = np.concatenate([host["fin_tokens"][slot], alive_tokens])
        lens = np.concatenate([host["fin_lens"][slot], host["seq_len"][alive]])
        ranked = rank_sequences(torch.from_numpy(scores), torch.from_numpy(lens),
                                self.options.length_penalty)
        best = int(np.argmax(ranked.numpy()))

        sampled = tokens[best, self.prompt_len:]
        eot_pos = np.nonzero(sampled == tok.eot)[0]
        cut = int(eot_pos[0]) if len(eot_pos) else len(sampled)
        toks = sampled[:cut].tolist()
        text = tok.decode(toks).strip()
        result = DecodingResult(
            tokens=toks, text=text, language=entry.language, language_probs=None,
            avg_logprob=float(scores[best]) / max(int(lens[best]), 1),
            no_speech_prob=float(host["no_speech"][slot]),
            temperature=0.0, compression_ratio=compression_ratio(text))
        retry = _needs_fallback(result, self.options) and len(self.temperatures) > 1
        return result, retry

    # -- main loop -----------------------------------------------------------

    def run(self, windows: List[Any],
            arrivals: Optional[Callable[[], Optional[List[Any]]]] = None) -> List[Any]:
        """Decode every window on the t=0 beam rung (fills w.result);
        returns the windows that failed the quality gates, for the caller
        to route to the sampled engine's t>0 rungs. `arrivals` as in
        `ContinuousBatcher.run`."""
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

        while not pending:
            poll_arrivals()
            if closed and not pending:
                return []
            if not pending:
                time.sleep(0.002)
        bs, k = self.bs, self.k  # bs GROUPS per device batch
        active: List[Optional[_Slot]] = [None] * bs
        retries: List[Any] = []
        self._encode_pool(pending)
        state = self._empty_beam_state()

        def fill(state: CBBeamState, free: List[int], count: int) -> CBBeamState:
            rows, group = self._draw_from_pool(count)
            for i, s in zip(free, group):
                active[i] = s
            return scatter_beam_rows(state, rows, free[:len(group)], beam_size=k)

        state = fill(state, list(range(bs)), min(bs, self._pool_remaining()))
        while True:
            poll_arrivals()
            if any(a is not None for a in active):
                state = beam_decode_chunk(
                    self.model.decoder, state, self.suppress_mask, self.blank_mask,
                    self.max_init_idx, chunk=self.chunk,
                    use_timestamps=self.use_timestamps, prompt_len=self.prompt_len,
                    total_len=self.total_len, beam_size=k,
                    max_candidates=self.max_candidates)

            finished = state.finished.cpu().numpy()
            done = [s for s in range(bs) if active[s] is not None and finished[s]]
            if done:
                host = {name: getattr(state, name).cpu().numpy() for name in (
                    "tokens", "sum_lp", "seq_len", "pos", "no_speech", "fin_scores",
                    "fin_tokens", "fin_lens")}
            for s in done:
                entry = active[s]
                result, retry = self._harvest_group(host, s, entry)
                entry.window.result = result
                if retry:
                    retries.append(entry.window)
                active[s] = None

            free = [s for s in range(bs) if active[s] is None]
            supply = self._pool_remaining() + len(pending)
            if supply and (len(free) >= self.refill or all(a is None for a in active)):
                if self._pool_remaining() == 0:
                    self._encode_pool(pending)
                count = min(self.refill, len(free), self._pool_remaining())
                state = fill(state, free, count)
            if (not pending and self._pool_remaining() == 0
                    and all(a is None for a in active)):
                if closed:
                    break
                time.sleep(0.002)  # open-loop idle: the stream is still live
        return retries
