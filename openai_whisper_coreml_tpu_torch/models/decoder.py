"""Whisper text decoder: causal self-attention + audio cross-attention
(port of `models/decoder.py`).

One module serves teacher forcing over a whole sequence
(`decoder_forward`) and incremental decoding against a preallocated KV
cache (`decode_step`). Caches keep the JAX package's d-major layout
(L, B, H, D, C), so attention reads K/V as stored ("bthd,bhds->bhts").
Cross-attention K/V over the 1500 audio positions are computed once per
window, in bf16 (the model dtype) or int8 with per-(b, h, position) column
scales that are dequantised inline on read.

Unlike JAX, `decode_step` writes this step's K/V into the cache in place
and returns the same cache object.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..config import WhisperConfig
from .layers import (MLP, Attention, LayerNorm, frozen, layer_norm,
                     layer_slice, merge_heads, self_attention, split_heads)


class KVCache(NamedTuple):
    """Preallocated self-attention cache: (n_layers, B, H, D, ctx)."""

    k: torch.Tensor
    v: torch.Tensor


class CrossKV(NamedTuple):
    """Per-window audio K/V: (n_layers, B, H, D, n_audio_ctx), d-major."""

    k: torch.Tensor
    v: torch.Tensor


class QuantCrossKV(NamedTuple):
    """int8 cross K/V with per-(b, h, position) column scales."""

    k8: torch.Tensor  # (L, B, H, D, S) int8
    ks: torch.Tensor  # (L, B, H, 1, S) fp32
    v8: torch.Tensor
    vs: torch.Tensor


class DecoderBlock(nn.Module):
    def __init__(self, p: Mapping[str, Any], n_head: int):
        super().__init__()
        self.attn = Attention(p["attn"], n_head)
        self.attn_ln = LayerNorm(p["attn_ln"])
        self.cross_attn = Attention(p["cross_attn"], n_head)
        self.cross_attn_ln = LayerNorm(p["cross_attn_ln"])
        self.mlp = MLP(p["mlp"])
        self.mlp_ln = LayerNorm(p["mlp_ln"])


class TextDecoder(nn.Module):
    """Decoder weights: tied token embedding, learned positions, blocks, ln."""

    def __init__(self, cfg: WhisperConfig, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = frozen(p["token_embedding"])
        self.positional_embedding = frozen(p["positional_embedding"])
        self.blocks = nn.ModuleList(
            DecoderBlock(layer_slice(p["blocks"], l), cfg.n_text_head)
            for l in range(cfg.n_text_layer))
        self.ln = LayerNorm(p["ln"])


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
                  device: torch.device, ctx: Optional[int] = None) -> KVCache:
    """ctx: cache length, at most (and by default) the 448 text context."""
    ctx = cfg.n_text_ctx if ctx is None else min(ctx, cfg.n_text_ctx)
    shape = (cfg.n_text_layer, batch, cfg.n_text_head, cfg.text_head_dim, ctx)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def gather_cache(cache: KVCache, idx: torch.Tensor) -> KVCache:
    """Reorder the cache's batch rows (beam-search source gather); a copy."""
    return KVCache(cache.k[:, idx], cache.v[:, idx])


def to_dmajor(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, S, n_state) -> (B, H, D, S)."""
    b, s, n = x.shape
    return x.reshape(b, s, n_head, n // n_head).permute(0, 2, 3, 1)


def quantize_kv_column(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D, S) float -> (int8 values, (..., 1, S) fp32 scales)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def precompute_cross_kv(decoder: TextDecoder,
                        audio_features: torch.Tensor) -> CrossKV:
    """audio_features (B, S, n_state) -> stacked per-layer cross K/V."""
    ks, vs = [], []
    for blk in decoder.blocks:
        p = blk.cross_attn
        ks.append(to_dmajor(p.k(audio_features), p.n_head))
        vs.append(to_dmajor(p.v(audio_features), p.n_head))
    return CrossKV(torch.stack(ks), torch.stack(vs))


def precompute_cross_kv_int8(decoder: TextDecoder,
                             audio_features: torch.Tensor) -> QuantCrossKV:
    """Quantised variant of precompute_cross_kv (once per window)."""
    parts = []
    for blk in decoder.blocks:
        p = blk.cross_attn
        k8, ks = quantize_kv_column(to_dmajor(p.k(audio_features), p.n_head))
        v8, vs = quantize_kv_column(to_dmajor(p.v(audio_features), p.n_head))
        parts.append((k8, ks, v8, vs))
    return QuantCrossKV(*(torch.stack(t) for t in zip(*parts)))


def attention_dmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, T, H, D) against d-major k, v (B, H, D, S); mask broadcastable
    to (B, H, T, S), True = keep. Returns (B, T, H, D); fp32 softmax."""
    scale = q.shape[-1] ** -0.25
    qs = (q * scale).to(q.dtype)
    ks = (k * scale).to(k.dtype)
    logits = torch.einsum("bthd,bhds->bhts", qs.float(), ks.float())
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bhds->bthd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def embed_tokens(decoder: TextDecoder, tokens: torch.Tensor, pos_offset: int,
                 valid_from: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Token + learned-position embedding. Cache slot i holds logical position
    i - valid_from (left-pad bucketing); padded slots clamp to position 0 and
    are masked out of attention anyway. valid_from: int or (B,) per row."""
    b, t = tokens.shape
    vf = torch.as_tensor(valid_from, device=tokens.device).reshape(-1, 1)
    positions = torch.clamp(
        pos_offset + torch.arange(t, device=tokens.device)[None] - vf,
        0, decoder.cfg.n_text_ctx - 1).expand(b, t)
    return decoder.token_embedding[tokens] + decoder.positional_embedding[positions]


def final_logits(decoder: TextDecoder, x: torch.Tensor) -> torch.Tensor:
    """ln -> tied-embedding projection; logits returned in fp32."""
    x = layer_norm(x, decoder.ln)
    return (x @ decoder.token_embedding.to(x.dtype).T).float()


def _cross_attn(blk: DecoderBlock, x: torch.Tensor,
                cross_kv: Union[CrossKV, QuantCrossKV], l: int) -> torch.Tensor:
    p = blk.cross_attn
    q = split_heads(p.q(layer_norm(x, blk.cross_attn_ln)), p.n_head)
    if isinstance(cross_kv, QuantCrossKV):
        # inline dequantisation on read
        xk = (cross_kv.k8[l].float() * cross_kv.ks[l]).to(x.dtype)
        xv = (cross_kv.v8[l].float() * cross_kv.vs[l]).to(x.dtype)
        out = attention_dmajor(q, xk, xv)
    else:
        out = attention_dmajor(q, cross_kv.k[l], cross_kv.v[l])
    return p.out(merge_heads(out))


def decode_step(
    decoder: TextDecoder,
    tokens: torch.Tensor,  # (B, T) int64 — T tokens starting at pos_offset
    cross_kv: Union[CrossKV, QuantCrossKV],
    cache: KVCache,
    pos_offset: int,  # lockstep position of tokens[:, 0]
    valid_from: Union[int, torch.Tensor] = 0,  # slots [0, valid_from) are left-padding
) -> Tuple[torch.Tensor, KVCache]:
    """Incremental decode: (logits (B, T, vocab) fp32, cache). The cache's
    columns [pos_offset, pos_offset + T) are written in place."""
    x = embed_tokens(decoder, tokens, pos_offset, valid_from)
    b, t, _ = x.shape
    c = cache.k.shape[-1]
    dev = x.device
    q_pos = pos_offset + torch.arange(t, device=dev)[None, :, None]  # (1,T,1)
    k_pos = torch.arange(c, device=dev)[None, None, :]  # (1,1,C)
    vf = torch.as_tensor(valid_from, device=dev).reshape(-1, 1, 1)
    mask = ((k_pos <= q_pos) & (k_pos >= vf))[:, None]  # (B|1, 1, T, C)

    for l, blk in enumerate(decoder.blocks):
        p = blk.attn
        h = layer_norm(x, blk.attn_ln)
        q = split_heads(p.q(h), p.n_head)
        cache.k[l, ..., pos_offset:pos_offset + t] = to_dmajor(p.k(h), p.n_head)
        cache.v[l, ..., pos_offset:pos_offset + t] = to_dmajor(p.v(h), p.n_head)
        attn = attention_dmajor(q, cache.k[l], cache.v[l], mask=mask)
        x = x + p.out(merge_heads(attn))
        x = x + _cross_attn(blk, x, cross_kv, l)
        x = x + blk.mlp(layer_norm(x, blk.mlp_ln))
    return final_logits(decoder, x), cache


def decoder_forward(decoder: TextDecoder, tokens: torch.Tensor,
                    audio_features: Optional[torch.Tensor] = None,
                    cross_kv: Optional[CrossKV] = None) -> torch.Tensor:
    """Teacher-forcing forward over a full sequence -> logits (B, T, vocab)."""
    if cross_kv is None:
        if audio_features is None:
            raise ValueError("need audio_features or cross_kv")
        cross_kv = precompute_cross_kv(decoder, audio_features)
    x = embed_tokens(decoder, tokens, 0)
    for l, blk in enumerate(decoder.blocks):
        x = x + self_attention(layer_norm(x, blk.attn_ln), blk.attn, causal=True)
        x = x + _cross_attn(blk, x, cross_kv, l)
        x = x + blk.mlp(layer_norm(x, blk.mlp_ln))
    return final_logits(decoder, x)
