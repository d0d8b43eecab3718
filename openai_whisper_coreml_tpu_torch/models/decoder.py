"""Whisper text decoder: causal self-attention + audio cross-attention
(port of `models/decoder.py`).

One module serves teacher forcing over a whole sequence
(`decoder_forward`) and incremental decoding against a preallocated KV
cache (`decode_step`). Caches keep the JAX package's d-major layout
(L, B, H, D, C), so attention reads K/V as stored ("bthd,bhds->bhts").
The self-attention cache is bf16/fp32 (`KVCache`) or int8 with
per-(b, h, position) column scales (`QuantKVCache`); cross-attention K/V
over the 1500 audio positions are computed once per window, in the model
dtype or int8 (`QuantCrossKV`).

Single-token steps on the card run the Hopper decode kernels: `sqa_int8`
(K6) for int8 cross-attention and the int8 self-cache, `sqa_self` (K3) for
a bf16 self-cache when `self_kernel=True`. Prefill and the speculative
verify step (T > 1) and every CPU
step keep the JAX package's math: inline dequantisation, and K3's plain
version only with `self_kernel=True`.

Unlike JAX, `decode_step` writes this step's K/V into the cache in place
and returns the same cache object.

Teacher forcing (`decoder_forward`) takes `flash=True` from training and
from the word-timestamp pass (`timing.py`, which also reads each layer's
cross-attention probabilities through `visit`): its causal self-attention
then runs the flash kernel's causal mode on the card (JAX's
`decoder_block_full` never passes flash; the kernel's own docstring names
teacher forcing as the causal mode's use). The decode loops never set it.

Under a model axis (`parallel/`) each rank holds n_text_head / n_model
heads (`TextDecoder.n_head`): the caches and cross K/V hold the rank's
heads, so cache writes need no exchange, and K3 / K6 run on
(B, heads of the rank, 64, S). The tied-embedding logits stay replicated,
as JAX keeps the table whole.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import WhisperConfig
from ..ops.sqa_int8 import LayerAttend, sqa_int8_layers
from ..ops.sqa_self import sqa_self_layers
from ..quantize import ieee_div
from .layers import (MLP, Attention, LayerNorm, fp32_product, frozen,
                     layer_norm, layer_slice, merge_heads, self_attention,
                     split_heads)

Position = Union[int, torch.Tensor]


class KVCache(NamedTuple):
    """Preallocated self-attention cache: (n_layers, B, H, D, ctx)."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 self-attention cache with per-(b, h, position) column scales;
    the same d-major geometry as KVCache."""

    k8: torch.Tensor  # (L, B, H, D, C) int8
    ks: torch.Tensor  # (L, B, H, 1, C) fp32
    v8: torch.Tensor
    vs: torch.Tensor


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
    def __init__(self, p: Mapping[str, Any], n_head: int, axis=None):
        super().__init__()
        self.attn = Attention(p["attn"], n_head, axis)
        self.attn_ln = LayerNorm(p["attn_ln"])
        self.cross_attn = Attention(p["cross_attn"], n_head, axis)
        self.cross_attn_ln = LayerNorm(p["cross_attn_ln"])
        self.mlp = MLP(p["mlp"], axis)
        self.mlp_ln = LayerNorm(p["mlp_ln"])


class TextDecoder(nn.Module):
    """Decoder weights: tied token embedding, learned positions, blocks, ln.
    `axis`: the model axis of a mesh (`parallel.mesh.ModelAxis`) or None;
    `n_head` is this rank's heads per layer, the caches' head count."""

    def __init__(self, cfg: WhisperConfig, p: Mapping[str, Any], axis=None):
        super().__init__()
        self.cfg = cfg
        self.axis = axis
        self.n_head = (cfg.n_text_head if axis is None
                       else cfg.n_text_head // axis.size)
        self.token_embedding = frozen(p["token_embedding"])
        self.positional_embedding = frozen(p["positional_embedding"])
        self.blocks = nn.ModuleList(
            DecoderBlock(layer_slice(p["blocks"], l), cfg.n_text_head, axis)
            for l in range(cfg.n_text_layer))
        self.ln = LayerNorm(p["ln"])


def _cache_shape(cfg: WhisperConfig, batch: int, ctx: Optional[int],
                 n_head: Optional[int] = None) -> tuple:
    """ctx: cache length, at most (and by default) the 448 text context;
    n_head: the decoder's heads on this rank (`TextDecoder.n_head`; all of
    cfg's by default)."""
    ctx = cfg.n_text_ctx if ctx is None else min(ctx, cfg.n_text_ctx)
    return (cfg.n_text_layer, batch, n_head or cfg.n_text_head,
            cfg.text_head_dim, ctx)


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
                  device: torch.device, ctx: Optional[int] = None,
                  n_head: Optional[int] = None) -> KVCache:
    shape = _cache_shape(cfg, batch, ctx, n_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache_int8(cfg: WhisperConfig, batch: int, device: torch.device,
                       ctx: Optional[int] = None,
                       n_head: Optional[int] = None) -> QuantKVCache:
    """int8 variant of init_kv_cache (DecodingOptions.cache_dtype="int8")."""
    shape = _cache_shape(cfg, batch, ctx, n_head)
    sshape = shape[:3] + (1, shape[-1])
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(sshape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(sshape, dtype=torch.float32, device=device))


def init_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
               device: torch.device, ctx: Optional[int] = None,
               cache_dtype: str = "bf16",
               n_head: Optional[int] = None) -> Union[KVCache, QuantKVCache]:
    """The decode loops' cache: int8 for cache_dtype="int8", else `dtype`
    (the model's activation dtype, as in JAX); n_head as `_cache_shape`."""
    if cache_dtype == "int8":
        return init_kv_cache_int8(cfg, batch, device, ctx=ctx, n_head=n_head)
    return init_kv_cache(cfg, batch, dtype, device, ctx=ctx, n_head=n_head)


def use_self_kernel(cache: Union[KVCache, QuantKVCache]) -> bool:
    """The loops' `self_kernel`: K3 for a bf16 cache on the card. JAX leaves
    it off (a measured loss on the TPU); the H100's decode step is
    launch-bound, and K3 replaces a string of small launches. fp32 caches
    stay on the exact plain path."""
    return (isinstance(cache, KVCache) and cache.k.dtype == torch.bfloat16
            and cache.k.is_cuda)


def gather_cache(cache: Union[KVCache, QuantKVCache],
                 idx: torch.Tensor) -> Union[KVCache, QuantKVCache]:
    """Reorder the cache's batch rows (beam-search source gather); a copy."""
    return type(cache)(*(t[:, idx] for t in cache))


def to_dmajor(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, S, n_state) -> (B, H, D, S)."""
    b, s, n = x.shape
    return x.reshape(b, s, n_head, n // n_head).permute(0, 2, 3, 1)


def quantize_kv_column(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D, S) float -> (int8 values, (..., 1, S) fp32 scales)."""
    x32 = x.float()
    scale = torch.clamp(ieee_div(x32.abs().amax(dim=-2, keepdim=True), 127.0),
                        min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_column(x8: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Inline dequantisation on read: int8 values times column scales."""
    return (x8.float() * scale).to(dtype)


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


def precompute_cross(decoder: TextDecoder, audio_features: torch.Tensor,
                     kv_dtype: str = "bf16") -> Union[CrossKV, QuantCrossKV]:
    """The decode loops' cross-KV: int8 for kv_dtype="int8", else the
    features' dtype."""
    if kv_dtype == "int8":
        return precompute_cross_kv_int8(decoder, audio_features)
    return precompute_cross_kv(decoder, audio_features)


def attention_dmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     return_weights: bool = False):
    """q (B, T, H, D) against d-major k, v (B, H, D, S); mask broadcastable
    to (B, H, T, S), True = keep. Returns (B, T, H, D); fp32 softmax.
    `return_weights` also returns the softmax (B, H, T, S) fp32."""
    scale = q.shape[-1] ** -0.25
    qs = (q * scale).to(q.dtype)
    ks = (k * scale).to(k.dtype)
    logits = torch.einsum("bthd,bhds->bhts", qs.float(), ks.float())
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bhds->bthd", weights.to(v.dtype).float(), v.float())
    if return_weights:
        return out.to(q.dtype), weights
    return out.to(q.dtype)


def embed_tokens(decoder: TextDecoder, tokens: torch.Tensor,
                 pos_offset: Position,
                 valid_from: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Token + learned-position embedding. Cache slot i holds logical position
    i - valid_from (left-pad bucketing); padded slots clamp to position 0 and
    are masked out of attention anyway. pos_offset and valid_from: int or
    (B,) per row."""
    b, t = tokens.shape
    dev = tokens.device
    pos = pos_offset.reshape(-1, 1) if torch.is_tensor(pos_offset) else pos_offset
    vf = torch.as_tensor(valid_from, device=dev).reshape(-1, 1)
    positions = torch.clamp(pos + torch.arange(t, device=dev)[None] - vf,
                            0, decoder.cfg.n_text_ctx - 1).expand(b, t)
    return decoder.token_embedding[tokens] + decoder.positional_embedding[positions]


def final_logits(decoder: TextDecoder, x: torch.Tensor) -> torch.Tensor:
    """ln -> tied-embedding projection; logits returned in fp32, the
    product unrounded (JAX's `preferred_element_type=float32`)."""
    x = layer_norm(x, decoder.ln)
    return fp32_product(x, decoder.token_embedding.T)


CacheIndex = Union[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _cache_index(pos_offset: Position, cols: int, t: int = 1) -> CacheIndex:
    """Where a step writes its K/V, computed once per step: the first
    column (lockstep), or for (B,) per-row positions (rows, each row's
    columns clamped into the cache, True where a column lies inside the
    cache). T == 1: rows (B,), columns (B,), inside (B, 1, 1). T > 1 (the
    speculative verify step): rows (B, 1), columns (B, T), inside
    (B, T, 1, 1)."""
    if not torch.is_tensor(pos_offset):
        return pos_offset
    rows = torch.arange(pos_offset.shape[0], device=pos_offset.device)
    if t == 1:
        return (rows, pos_offset.clamp(max=cols - 1),
                (pos_offset < cols).reshape(-1, 1, 1))
    col = pos_offset[:, None] + torch.arange(t, device=pos_offset.device)
    return rows[:, None], col.clamp(max=cols - 1), (col < cols)[..., None, None]


def _cache_write(buf: torch.Tensor, l: int, val: torch.Tensor,
                 where: CacheIndex) -> None:
    """Write val (B, *, *, T) into layer l of buf (L, B, *, *, C) in place,
    at `_cache_index(pos_offset, C, T)`.

    Lockstep: columns [pos_offset, pos_offset + T). Per-row positions: row b
    at columns [pos_offset[b], pos_offset[b] + T); a column past the cache
    (a finished continuous-batching row at total_len == C) keeps the
    cache's contents, as JAX's out-of-range scatter drops the write. The
    advanced indices are separated by slices, so the indexed view is
    (B, *, *) for T == 1 and (B, T, *, *) for T > 1. Columns past the
    cache all clamp to C - 1; each of them writes what the row's column
    C - 1 gets, so the duplicate writes agree.
    """
    if not isinstance(where, tuple):
        buf[l, ..., where:where + val.shape[-1]] = val
        return
    rows, col, inside = where
    if col.ndim == 1:
        buf[l, rows, :, :, col] = torch.where(inside, val[..., 0],
                                              buf[l, rows, :, :, col])
        return
    t = col.shape[1]
    new = torch.where(inside, val.permute(0, 3, 1, 2), buf[l, rows, :, :, col])
    # first j whose column clamps to C - 1; later ones repeat its value
    first_last = (buf.shape[-1] - 1 - col[:, :1]).clamp(0, t - 1)
    src = torch.minimum(torch.arange(t, device=col.device)[None], first_last)
    new = new.gather(1, src[..., None, None].expand_as(new))
    buf[l, rows, :, :, col] = new

def _cross_attn(blk: DecoderBlock, x: torch.Tensor,
                cross_kv: Union[CrossKV, QuantCrossKV], l: int,
                attend: Optional[LayerAttend] = None) -> torch.Tensor:
    """attend: a single-token step's K6 entry over int8 cross K/V (on the
    card), used instead of inline dequantisation."""
    p = blk.cross_attn
    q = split_heads(p.q(layer_norm(x, blk.cross_attn_ln)), p.n_head)
    if attend is not None:
        out = attend(q, l)
    elif isinstance(cross_kv, QuantCrossKV):
        k8, ks, v8, vs = (t[l] for t in cross_kv)
        out = attention_dmajor(q, dequantize_kv_column(k8, ks, x.dtype),
                               dequantize_kv_column(v8, vs, x.dtype))
    else:
        out = attention_dmajor(q, cross_kv.k[l], cross_kv.v[l])
    return p.out(merge_heads(out))


def decode_step(
    decoder: TextDecoder,
    tokens: torch.Tensor,  # (B, T) int64 — T tokens starting at pos_offset
    cross_kv: Union[CrossKV, QuantCrossKV],
    cache: Union[KVCache, QuantKVCache],
    pos_offset: Position,  # int (lockstep) or (B,) per-row positions
    valid_from: Union[int, torch.Tensor] = 0,  # slots [0, valid_from) are left-padding
    self_kernel: bool = False,  # single-token self-attention through K3
    # (`ops.sqa_self`: the kernel on the card, its plain version on the CPU),
    # JAX's meaning; it computes in bf16 and needs a KVCache
) -> Tuple[torch.Tensor, Union[KVCache, QuantKVCache]]:
    """Incremental decode: (logits (B, T, vocab) fp32, cache). The cache's
    columns [pos_offset, pos_offset + T) are written in place.

    With a (B,) pos_offset each row decodes at its own position:
    continuous batching (T == 1), or the speculative verify step (T = K+1
    candidate tokens at row-independent columns, attended in plain PyTorch
    with the per-row causal mask, as JAX computes it in XLA). Single-token
    steps on CUDA tensors run the decode kernels: K6 for int8 cross K/V and
    for a QuantKVCache, K3 for a KVCache when self_kernel is set.
    """
    b, t = tokens.shape
    rowpos = torch.is_tensor(pos_offset)
    if rowpos and tuple(pos_offset.shape) != (b,):
        raise ValueError(f"per-row positions need a ({b},) pos_offset; got "
                         f"{tuple(pos_offset.shape)}")
    if rowpos and t != 1 and self_kernel:
        raise ValueError("self_kernel requires single-token decode")
    x = embed_tokens(decoder, tokens, pos_offset, valid_from)
    dev = x.device
    quant_self = isinstance(cache, QuantKVCache)
    on_card = t == 1 and dev.type == "cuda"
    c = cache[0].shape[-1]
    where = _cache_index(pos_offset, c, t)
    # the kernels' entries check the caches and bounds once per step
    self_attend = cross_attend = None
    if quant_self and on_card:
        self_attend = sqa_int8_layers(*cache, pos_offset, valid_from)
    elif self_kernel and t == 1 and not quant_self:
        self_attend = sqa_self_layers(cache.k, cache.v, pos_offset, valid_from)
    if on_card and isinstance(cross_kv, QuantCrossKV):
        cross_attend = sqa_int8_layers(*cross_kv, cross_kv.k8.shape[-1] - 1, 0)
    mask = None
    if self_attend is None:
        q_pos = (torch.as_tensor(pos_offset, device=dev).reshape(-1, 1, 1)
                 + torch.arange(t, device=dev)[None, :, None])  # (B|1,T,1)
        k_pos = torch.arange(c, device=dev)[None, None, :]  # (1,1,C)
        vf = torch.as_tensor(valid_from, device=dev).reshape(-1, 1, 1)
        mask = ((k_pos <= q_pos) & (k_pos >= vf))[:, None]  # (B|1, 1, T, C)

    for l, blk in enumerate(decoder.blocks):
        p = blk.attn
        h = layer_norm(x, blk.attn_ln)
        q = split_heads(p.q(h), p.n_head)
        k_new = to_dmajor(p.k(h), p.n_head)
        v_new = to_dmajor(p.v(h), p.n_head)
        if quant_self:
            for buf, val in zip(cache, (*quantize_kv_column(k_new),
                                        *quantize_kv_column(v_new))):
                _cache_write(buf, l, val, where)
        else:
            _cache_write(cache.k, l, k_new.to(cache.k.dtype), where)
            _cache_write(cache.v, l, v_new.to(cache.v.dtype), where)
        if self_attend is not None:
            attn = self_attend(q, l)
        elif quant_self:
            k8, ks, v8, vs = (buf[l] for buf in cache)
            attn = attention_dmajor(q, dequantize_kv_column(k8, ks, x.dtype),
                                    dequantize_kv_column(v8, vs, x.dtype), mask=mask)
        else:
            attn = attention_dmajor(q, cache.k[l], cache.v[l], mask=mask)
        x = x + p.out(merge_heads(attn))
        x = x + _cross_attn(blk, x, cross_kv, l, cross_attend)
        x = x + blk.mlp(layer_norm(x, blk.mlp_ln))
    return final_logits(decoder, x), cache


def decoder_block_full(blk: DecoderBlock, x: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       flash: bool = False,
                       visit: Optional[Callable[[torch.Tensor], None]] = None
                       ) -> torch.Tensor:
    """Teacher-forcing block: full causal self-attention (no cache);
    `visit` gets the cross-attention probabilities (B, H, T, S) fp32."""
    x = x + self_attention(layer_norm(x, blk.attn_ln), blk.attn, causal=True,
                           flash=flash)
    p = blk.cross_attn
    q = split_heads(p.q(layer_norm(x, blk.cross_attn_ln)), p.n_head)
    out, weights = attention_dmajor(q, cross_k, cross_v, return_weights=True)
    if visit is not None:
        visit(weights)
    x = x + p.out(merge_heads(out))
    return x + blk.mlp(layer_norm(x, blk.mlp_ln))


def decoder_forward(decoder: TextDecoder, tokens: torch.Tensor,
                    audio_features: Optional[torch.Tensor] = None,
                    cross_kv: Optional[CrossKV] = None, *,
                    remat: bool = False, flash: bool = False,
                    visit: Optional[Callable[[int, torch.Tensor], None]] = None
                    ) -> torch.Tensor:
    """Teacher-forcing forward over a full sequence -> logits (B, T, vocab).

    `remat` recomputes each block in the backward pass (the cross K/V are
    computed once, outside the blocks, as in JAX); `flash` runs the causal
    self-attention through `ops.flash_attention`; `visit(l, w)` gets layer
    l's cross-attention probabilities (B, H, T, S) fp32 (the word-timestamp
    pass; not with `remat`, whose backward would visit again)."""
    if cross_kv is None:
        if audio_features is None:
            raise ValueError("need audio_features or cross_kv")
        cross_kv = precompute_cross_kv(decoder, audio_features)
    x = embed_tokens(decoder, tokens, 0)
    for l, blk in enumerate(decoder.blocks):
        args = (blk, x, cross_kv.k[l], cross_kv.v[l], flash,
                None if visit is None else functools.partial(visit, l))
        if remat:
            x = checkpoint(decoder_block_full, *args, use_reentrant=False)
        else:
            x = decoder_block_full(*args)
    return final_logits(decoder, x)
