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
  * finalize: alive beams join the finished ones, the top max_candidates
    by raw score are returned for `rank_sequences` (avg log-prob, or the
    GNMT length penalty ((5+L)/6)^p).

The JAX two-level loop (deferred reordering through `frozen_origin`) works
around an XLA-TPU layout cost and gives the same candidates; it is not
ported. Top-k breaks ties toward the lower index, as XLA's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .models import decoder as dec_mod


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, sorted, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, L), idx (B, M) -> (B, M, L)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


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
    from .decoding import NEG_INF, _apply_logit_rules

    cfg = decoder.cfg
    dev = audio_features.device
    b = audio_features.shape[0]
    k = beam_size
    bk = b * k
    v = cfg.n_vocab
    eot = cfg.eot_token
    total_len = prompt_len + sample_len

    # prompts replicate across beams; cross-KV is computed once per row
    init = initial_tokens.to(device=dev, dtype=torch.long).repeat_interleave(k, dim=0)
    cross_b = dec_mod.precompute_cross(decoder, audio_features, kv_dtype)
    cross_kv = type(cross_b)(*(t.repeat_interleave(k, dim=1) for t in cross_b))
    cache_len = min(-(-total_len // 128) * 128, cfg.n_text_ctx)
    cache = dec_mod.init_cache(cfg, bk, audio_features.dtype, dev, ctx=cache_len,
                               cache_dtype=cache_dtype)
    self_kernel = dec_mod.use_self_kernel(cache)

    tokens = torch.full((bk, total_len), eot, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = init

    prefill_logits, cache = dec_mod.decode_step(
        decoder, init, cross_kv, cache, 0, valid_from=pad_len)
    no_speech_prob = torch.softmax(prefill_logits[:, sot_index], dim=-1)[
        :, cfg.no_speech_token].reshape(b, k)[:, 0]

    logits = prefill_logits[:, -1]
    sum_lp = torch.zeros(bk, dtype=torch.float32, device=dev)
    seq_len = torch.zeros(bk, dtype=torch.long, device=dev)
    # ts_max sentinel: ts_begin - 1 == "no timestamp sampled yet"
    ts_max = torch.full((bk,), cfg.timestamp_begin - 1, dtype=torch.long, device=dev)
    fin_scores = torch.full((b, max_candidates), NEG_INF, device=dev)
    fin_tokens = torch.full((b, max_candidates, total_len), eot,
                            dtype=torch.long, device=dev)
    fin_lens = torch.zeros((b, max_candidates), dtype=torch.long, device=dev)
    later_beams = (torch.arange(bk, device=dev) % k) > 0
    batch_base = (torch.arange(b, device=dev) * k)[:, None]

    pos = prompt_len
    while pos < total_len and bool(
            (sum_lp.reshape(b, k).amax(dim=1) > fin_scores.amin(dim=1)).any()):
        filtered = _apply_logit_rules(
            logits, tokens, pos, cfg, prompt_len, suppress_mask, blank_mask,
            use_timestamps, ts_max, max_initial_ts_index)
        logprobs = torch.log_softmax(filtered, dim=-1)  # (B*K, V)

        # first sampled step: only beam 0 proposes (identical prefixes)
        alive_mask = torch.where(later_beams & (pos == prompt_len), NEG_INF, 0.0)
        cand = (sum_lp[:, None] + logprobs + alive_mask[:, None]).reshape(b, k * v)
        top_scores, top_idx = _top_k(cand, 2 * k)  # (B, 2K)
        src_beam = top_idx // v
        tok = top_idx % v
        is_eot = tok == eot

        # finished buffer: EOT candidates are the source beam's tokens with
        # EOT at pos; their length excludes the EOT
        eot_scores = torch.where(is_eot, top_scores, NEG_INF)
        src_rows = _take_rows(tokens.reshape(b, k, total_len), src_beam)
        src_rows[:, :, pos] = eot
        cand_lens = seq_len.reshape(b, k).gather(1, src_beam)
        fin_scores, keep_idx = _top_k(torch.cat([fin_scores, eot_scores], 1),
                                      max_candidates)
        fin_tokens = _take_rows(torch.cat([fin_tokens, src_rows], 1), keep_idx)
        fin_lens = torch.cat([fin_lens, cand_lens], 1).gather(1, keep_idx)

        # K continuing (non-EOT) beams
        new_scores, pick = _top_k(torch.where(is_eot, NEG_INF, top_scores), k)
        new_tok = tok.gather(1, pick).reshape(bk)
        new_src = src_beam.gather(1, pick)
        flat_src = (batch_base + new_src).reshape(bk)
        tokens = tokens[flat_src]
        tokens[:, pos] = new_tok
        sum_lp = new_scores.reshape(bk)
        seq_len = seq_len.reshape(b, k).gather(1, new_src).reshape(bk) + 1
        ts_src = ts_max.reshape(b, k).gather(1, new_src).reshape(bk)
        ts_max = torch.where(new_tok >= cfg.timestamp_begin, new_tok, ts_src)

        cache = dec_mod.gather_cache(cache, flat_src)
        next_logits, cache = dec_mod.decode_step(
            decoder, new_tok[:, None], cross_kv, cache, pos, valid_from=pad_len,
            self_kernel=self_kernel)
        logits = next_logits[:, 0]
        pos += 1

    # openai finalize: the still-alive beams (EOT appended, score unchanged)
    # compete with the finished ones
    if pos < total_len:
        tokens[:, pos] = eot
    all_scores = torch.cat([fin_scores, sum_lp.reshape(b, k)], 1)
    all_tokens = torch.cat([fin_tokens, tokens.reshape(b, k, total_len)], 1)
    all_lens = torch.cat([fin_lens, seq_len.reshape(b, k)], 1)
    keep_scores, keep_idx = _top_k(all_scores, max_candidates)
    return (_take_rows(all_tokens, keep_idx), keep_scores,
            all_lens.gather(1, keep_idx), no_speech_prob)


def rank_sequences(scores: torch.Tensor, lengths: torch.Tensor,
                   length_penalty: Optional[float]) -> torch.Tensor:
    """openai MaximumLikelihoodRanker: avg log-prob, or GNMT length penalty."""
    lengths = torch.clamp(lengths.float(), min=1.0)
    if length_penalty is None:
        return scores / lengths
    return scores / (((5.0 + lengths) / 6.0) ** length_penalty)
