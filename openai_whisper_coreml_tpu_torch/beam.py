"""Beam-search decoding (port of `beam.py`).

The JAX package's flat formulation, step for step:

  * beams flattened into the batch axis (B*K rows share one KV cache);
  * each step: top-2K candidates from the (K x V) merged scores; the first
    K non-EOT continue, EOT candidates merge into a per-batch finished
    buffer (top max_candidates = round(beam_size * patience) kept);
  * the KV cache (bf16 or int8) reordered per step by gathering the beams'
    source rows;
  * first-step degeneracy broken by masking beams 1..K-1 to -inf;
  * early exit when no alive beam can beat the worst kept finished score;
  * one step (`beam_step`) serves the lockstep loop here and the
    continuous scheduler's groups (`serve_cb_beam`), each group at its own
    position and with its own finished flag;
  * finalize: alive beams join the finished ones, the top max_candidates
    by raw score are returned for `rank_sequences` (avg log-prob, or the
    GNMT length penalty ((5+L)/6)^p).

The JAX two-level loop (deferred reordering through `frozen_origin`) works
around an XLA-TPU layout cost and gives the same candidates; it is not
ported. Top-k breaks ties toward the lower index, as XLA's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from .models import decoder as dec_mod
from .quantize import ieee_div


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, sorted, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, L), idx (B, M) -> (B, M, L)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


class BeamState(NamedTuple):
    """Beam-decode state of G groups x K rows: a group is one request's K
    beams, which share one position."""

    tokens: torch.Tensor  # (G*K, total_len) int64
    logits: torch.Tensor  # (G*K, V) fp32: logits for each group's `pos`
    sum_lp: torch.Tensor  # (G*K,) fp32: alive-beam cumulative scores
    seq_len: torch.Tensor  # (G*K,) int64: text tokens per alive beam
    ts_max: torch.Tensor  # (G*K,) int64
    pad: torch.Tensor  # (G*K,) int64 per-row left-pads
    pos: torch.Tensor  # (G,) int64: per-group next position
    finished: torch.Tensor  # (G,) bool
    no_speech: torch.Tensor  # (G,) fp32
    fin_scores: torch.Tensor  # (G, C) fp32: finished-candidate buffer
    fin_tokens: torch.Tensor  # (G, C, total_len) int64
    fin_lens: torch.Tensor  # (G, C) int64
    cache: Union[dec_mod.KVCache, dec_mod.QuantKVCache]  # G*K rows
    cross_kv: Union[dec_mod.CrossKV, dec_mod.QuantCrossKV]  # G*K rows


def beam_step(
    decoder: dec_mod.TextDecoder,
    st: BeamState,
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    max_initial_ts_index: int,
    *,
    use_timestamps: bool,
    prompt_len: int,
    beam_size: int,
    max_candidates: int,
    self_kernel: bool,
) -> Tuple[BeamState, torch.Tensor]:
    """One beam step of every group at its own position: the top-2K merge,
    EOT candidates into the finished buffer, the K continuing beams, the
    cache gather and the next decode step. A finished group gathers its own
    rows and keeps its tokens, scores and logits. `pos` and `finished` are
    left to the caller's stop rule. Returns (state, the continuing beams'
    scores (G, K))."""
    from .decoding import NEG_INF, _apply_logit_rules

    cfg = decoder.cfg
    eot = cfg.eot_token
    k = beam_size
    gk, total_len = st.tokens.shape
    g = gk // k
    v = cfg.n_vocab
    dev = st.tokens.device
    rows = torch.arange(gk, device=dev)
    group_of_row = rows // k
    pos_rep = st.pos[group_of_row]  # (G*K,)
    fin_rep = st.finished[group_of_row]  # (G*K,)
    filtered = _apply_logit_rules(
        st.logits, st.tokens, pos_rep, cfg, prompt_len, suppress_mask,
        blank_mask, use_timestamps, st.ts_max, max_initial_ts_index)
    logprobs = torch.log_softmax(filtered, dim=-1)  # (G*K, V)

    # a group's first step: only beam 0 proposes (identical prefixes)
    alive_mask = torch.where(((rows % k) > 0) & (pos_rep == prompt_len), NEG_INF, 0.0)
    cand = (st.sum_lp[:, None] + logprobs + alive_mask[:, None]).reshape(g, k * v)
    top_scores, top_idx = _top_k(cand, 2 * k)  # (G, 2K)
    src_beam = top_idx // v
    tok = top_idx % v
    is_eot = tok == eot

    # finished-candidate buffer, gated per group: EOT candidates are the
    # source beam's tokens with EOT at the group's position; their length
    # excludes the EOT
    eot_scores = torch.where(is_eot & ~st.finished[:, None], top_scores, NEG_INF)
    src_rows = _take_rows(st.tokens.reshape(g, k, total_len), src_beam)
    col3 = torch.arange(total_len, device=dev)[None, None, :]
    pos3 = st.pos.clamp(max=total_len - 1)[:, None, None]
    src_rows = torch.where(col3 == pos3, eot, src_rows)
    cand_lens = st.seq_len.reshape(g, k).gather(1, src_beam)
    fin_scores, keep_idx = _top_k(torch.cat([st.fin_scores, eot_scores], 1),
                                  max_candidates)
    fin_tokens = _take_rows(torch.cat([st.fin_tokens, src_rows], 1), keep_idx)
    fin_lens = torch.cat([st.fin_lens, cand_lens], 1).gather(1, keep_idx)

    # K continuing (non-EOT) beams per group; finished groups keep their rows
    new_scores, pick = _top_k(torch.where(is_eot, NEG_INF, top_scores), k)
    new_src = src_beam.gather(1, pick)
    group_base = (torch.arange(g, device=dev) * k)[:, None]
    flat_src = torch.where(fin_rep, rows, (group_base + new_src).reshape(gk))
    newt = torch.where(fin_rep, eot, tok.gather(1, pick).reshape(gk))

    write_pos = pos_rep.clamp(max=total_len - 1)
    tokens = st.tokens[flat_src]
    tokens[rows, write_pos] = torch.where(fin_rep, tokens[rows, write_pos], newt)
    sum_lp = torch.where(fin_rep, st.sum_lp, new_scores.reshape(gk))
    seq_len = torch.where(
        fin_rep, st.seq_len,
        st.seq_len.reshape(g, k).gather(1, new_src).reshape(gk) + 1)
    ts_src = st.ts_max.reshape(g, k).gather(1, new_src).reshape(gk)
    ts_max = torch.where(fin_rep, st.ts_max,
                         torch.where(newt >= cfg.timestamp_begin, newt, ts_src))
    pad = st.pad[flat_src]

    cache = dec_mod.gather_cache(st.cache, flat_src)
    next_logits, cache = dec_mod.decode_step(
        decoder, newt[:, None], st.cross_kv, cache, write_pos, valid_from=pad,
        self_kernel=self_kernel)
    logits = torch.where(fin_rep[:, None], st.logits, next_logits[:, 0])
    return st._replace(tokens=tokens, logits=logits, sum_lp=sum_lp, seq_len=seq_len,
                       ts_max=ts_max, pad=pad, fin_scores=fin_scores,
                       fin_tokens=fin_tokens, fin_lens=fin_lens,
                       cache=cache), new_scores


def beam_decode_core(
    decoder: dec_mod.TextDecoder,
    audio_features: torch.Tensor,  # (B, S, n_state)
    initial_tokens: torch.Tensor,  # (B, P) left-padded to the P bucket
    suppress_mask: torch.Tensor,  # (V,) bool
    blank_mask: torch.Tensor,  # (V,) bool
    max_initial_ts_index: int,  # -1 disables
    pad_len: int,
    sot_index: int,
    *,
    sample_len: int,
    use_timestamps: bool,
    prompt_len: int,
    beam_size: int,
    max_candidates: int,
    kv_dtype: str = "bf16",
    cache_dtype: str = "bf16",
):
    """Returns (tokens (B, max_candidates, P+sample_len), sum_logprobs
    (B, max_candidates), lengths (B, max_candidates), no_speech_prob (B,));
    lengths count text tokens, without the closing EOT."""
    from .decoding import NEG_INF

    cfg = decoder.cfg
    dev = audio_features.device
    b = audio_features.shape[0]
    k = beam_size
    bk = b * k
    eot = cfg.eot_token
    total_len = prompt_len + sample_len

    # prompts replicate across beams; cross-KV is computed once per row
    init = initial_tokens.to(device=dev, dtype=torch.long).repeat_interleave(k, dim=0)
    cross_b = dec_mod.precompute_cross(decoder, audio_features, kv_dtype)
    cross_kv = type(cross_b)(*(t.repeat_interleave(k, dim=1) for t in cross_b))
    cache_len = min(-(-total_len // 128) * 128, cfg.n_text_ctx)
    cache = dec_mod.init_cache(cfg, bk, audio_features.dtype, dev, ctx=cache_len,
                               cache_dtype=cache_dtype, n_head=decoder.n_head)

    tokens = torch.full((bk, total_len), eot, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = init

    prefill_logits, cache = dec_mod.decode_step(
        decoder, init, cross_kv, cache, 0, valid_from=pad_len)
    st = BeamState(
        tokens=tokens,
        logits=prefill_logits[:, -1],
        sum_lp=torch.zeros(bk, dtype=torch.float32, device=dev),
        seq_len=torch.zeros(bk, dtype=torch.long, device=dev),
        # ts_max sentinel: ts_begin - 1 == "no timestamp sampled yet"
        ts_max=torch.full((bk,), cfg.timestamp_begin - 1, dtype=torch.long, device=dev),
        pad=torch.full((bk,), pad_len, dtype=torch.long, device=dev),
        pos=torch.full((b,), prompt_len, dtype=torch.long, device=dev),
        finished=torch.zeros(b, dtype=torch.bool, device=dev),
        no_speech=torch.softmax(prefill_logits[:, sot_index], dim=-1)[
            :, cfg.no_speech_token].reshape(b, k)[:, 0],
        fin_scores=torch.full((b, max_candidates), NEG_INF, device=dev),
        fin_tokens=torch.full((b, max_candidates, total_len), eot,
                              dtype=torch.long, device=dev),
        fin_lens=torch.zeros((b, max_candidates), dtype=torch.long, device=dev),
        cache=cache,
        cross_kv=cross_kv,
    )
    self_kernel = dec_mod.use_self_kernel(cache)

    # lockstep: every group steps until the horizon, or until no alive beam
    # of any group can beat its worst kept finished candidate
    pos = prompt_len
    while pos < total_len and bool(
            (st.sum_lp.reshape(b, k).amax(dim=1) > st.fin_scores.amin(dim=1)).any()):
        st, _ = beam_step(decoder, st, suppress_mask, blank_mask,
                          max_initial_ts_index, use_timestamps=use_timestamps,
                          prompt_len=prompt_len, beam_size=k,
                          max_candidates=max_candidates, self_kernel=self_kernel)
        pos += 1
        st = st._replace(pos=st.pos + 1)

    # openai finalize: the still-alive beams (EOT appended, score unchanged)
    # compete with the finished ones
    tokens = st.tokens
    if pos < total_len:
        tokens[:, pos] = eot
    all_scores = torch.cat([st.fin_scores, st.sum_lp.reshape(b, k)], 1)
    all_tokens = torch.cat([st.fin_tokens, tokens.reshape(b, k, total_len)], 1)
    all_lens = torch.cat([st.fin_lens, st.seq_len.reshape(b, k)], 1)
    keep_scores, keep_idx = _top_k(all_scores, max_candidates)
    return (_take_rows(all_tokens, keep_idx), keep_scores,
            all_lens.gather(1, keep_idx), st.no_speech)


def rank_sequences(scores: torch.Tensor, lengths: torch.Tensor,
                   length_penalty: Optional[float]) -> torch.Tensor:
    """openai MaximumLikelihoodRanker: avg log-prob, or GNMT length penalty."""
    lengths = torch.clamp(lengths.float(), min=1.0)
    if length_penalty is None:
        return scores / lengths
    return scores / (ieee_div(5.0 + lengths, 6.0) ** length_penalty)
