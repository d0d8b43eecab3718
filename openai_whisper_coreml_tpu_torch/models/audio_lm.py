"""An audio language model on the Whisper encoder: Uni-MoE-2.0-Omni's audio
path (`config.UniMoEConfig`).

    mel (B, n_mels, 3000) -> `encoder.AudioEncoder` (B, 1500, n_audio_state)
    -> the connector: adaptive average pooling to `audio_tokens` frames
       (bin i averages frames floor(i*1500/A) .. ceil((i+1)*1500/A) - 1),
       then one linear with bias to `hidden`
    -> each clip's tokens: its text before the audio, the audio embeddings,
       its text after them
    -> `n_layer` decoder layers (Qwen2's, with a MoE MLP):
           h = h + o(attention(rope(q), rope(k), v))   GQA, causal
           h = h + moe(rms_norm(h))                     `models/moe.MoE`
       where q, k, v = linears of rms_norm(h) with bias, o without
    -> rms_norm, the untied head, log-softmax

Positions are 1-D and sequential from 0 in each clip (M-RoPE with equal
temporal, height and width positions is RoPE). RoPE rotates halves, as
Qwen2 does, with inverse frequencies theta^(-2i/head_dim).

A call's tokens are packed: clip after clip, one row each, with no pad
row through any linear or expert (`Layout`). Attention lays the rows out
as (B, T_max), right-padded, for `torch.nn.functional.scaled_dot_product_attention`
with `is_causal`, which is exact for every real row, and gathers them
back. The residual stream is fp32; the norms' outputs and the linears'
inputs and outputs are in the weights' dtype (bf16 on the card), each
sublayer's output added to the stream in fp32. A cache
(`AudioLM.new_cache`, the weights' dtype) holds each layer's rotated K and
V as (B, n_kv_head, T_cap, head_dim) for `generate`'s single-token steps.

Weights: `model_from_params` takes a tree whose "layers" is any sequence
of per-layer trees (`init_params` gives one that makes each layer when it
is read) and, with quantize="int8", quantizes each layer as it builds it,
so that a layer's float weights and its int8 copy are never held with the
rest. The int8 rule is `quantize.quantize_params`' (every linear weight
of `min_quant_size` elements or more; a stacked (E, in, out) expert
weight gets a scale per expert and output column), leaving the router in
fp32. Entry points: `lm_decoding.answer` and `lm_decoding.generate`.
"""

from __future__ import annotations

import dataclasses
import math
from collections import abc
from typing import Any, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import UniMoEConfig
from ..params import init_params as init_whisper_params
from ..quantize import MIN_QUANT_SIZE, quantize_params
from ..utils.profiling import annotate
from .encoder import AudioEncoder
from .layers import (Linear, RMSNorm, fp32_product, frozen, rms_norm,
                     scale_bias_cast)
from .moe import MoE

Prompt = Tuple[Sequence[int], Sequence[int]]  # text before the audio, text after it
KV = Tuple[torch.Tensor, torch.Tensor]  # one layer's cached K and V


@dataclasses.dataclass
class Layout:
    """Where a call's packed rows come from and where they go: clip b's
    rows are [starts[b], starts[b] + lengths[b]); the index tensors live
    on the model's device."""

    lengths: List[int]
    t_max: int
    text_ids: torch.Tensor  # (n_text,) token ids
    text_rows: torch.Tensor  # (n_text,) their packed rows
    audio_rows: torch.Tensor  # (B * audio_tokens,) the audio embeddings' rows
    positions: torch.Tensor  # (N,) each row's position in its clip
    pad_rows: torch.Tensor  # (N,) each row's row in the (B * t_max) padded layout
    last_rows: torch.Tensor  # (B,) each clip's last row

    @property
    def batch(self) -> int:
        return len(self.lengths)


def pack(prompts: Sequence[Prompt], audio_tokens: int, device) -> Layout:
    """The layout of clips whose tokens are `before + audio + after`, made
    on the host and moved to `device` in one copy."""
    lengths = [len(a) + audio_tokens + len(b) for a, b in prompts]
    t_max = max(lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    text_ids, text_rows, audio_rows, positions, pad_rows = [], [], [], [], []
    for i, ((before, after), s, n) in enumerate(zip(prompts, starts, lengths)):
        na = len(before)
        text_ids += [before, after]
        text_rows += [s + np.arange(na), s + na + audio_tokens + np.arange(len(after))]
        audio_rows.append(s + na + np.arange(audio_tokens))
        positions.append(np.arange(n))
        pad_rows.append(i * t_max + np.arange(n))
    parts = [np.concatenate([np.asarray(t, np.int64).reshape(-1) for t in text_ids]),
             np.concatenate(text_rows), np.concatenate(audio_rows),
             np.concatenate(positions), np.concatenate(pad_rows),
             starts + np.asarray(lengths) - 1]
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(device)
    views = torch.split(flat, [len(p) for p in parts])
    return Layout(lengths, t_max, *views)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (N, head_dim) fp32 at the rows' positions."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64,
                                        device=positions.device).float() / head_dim))
    f = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (N, H, D) rotated in fp32 (halves), cast back to x's dtype."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x32 * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def concat_linears(ps: Sequence[Mapping[str, torch.Tensor]]) -> dict:
    """Linears of one input side by side, as one (in, sum of out) linear:
    their weights, scales and biases joined along the output axis (an
    int8 scale is per output column, so the join is exact)."""
    return {key: torch.cat([p[key] for p in ps], dim=-1) for key in ps[0]}


class GQAttention(nn.Module):
    """q, k, v (with bias) as one linear, o without; `n_head` query heads
    over `n_kv_head` key/value heads."""

    def __init__(self, p: Mapping[str, Any], cfg: UniMoEConfig):
        super().__init__()
        self.n_head, self.n_kv, self.d = cfg.n_head, cfg.n_kv_head, cfg.head_dim
        self.qkv = Linear(concat_linears([p["q"], p["k"], p["v"]]))
        self.o = Linear(p["o"])

    def _split(self, x: torch.Tensor, rope):
        qkv = self.qkv(x)
        nq, nk = self.n_head * self.d, self.n_kv * self.d
        q = qkv[:, :nq].reshape(-1, self.n_head, self.d)
        k = qkv[:, nq:nq + nk].reshape(-1, self.n_kv, self.d)
        v = qkv[:, nq + nk:].reshape(-1, self.n_kv, self.d)
        return apply_rope(q, *rope), apply_rope(k, *rope), v

    def prefill(self, x: torch.Tensor, rope, lay: Layout, kv=None) -> torch.Tensor:
        """x (N, hidden) packed rows -> (N, hidden); writes the clips' K, V
        into `kv` (a cache layer) when given."""
        q, k, v = self._split(x, rope)
        with annotate("attention"):
            b, t = lay.batch, lay.t_max

            def padded(z):
                buf = z.new_zeros(b * t, z.shape[1], z.shape[2])
                buf.index_copy_(0, lay.pad_rows, z)
                return buf.view(b, t, z.shape[1], z.shape[2]).transpose(1, 2)

            qp, kp, vp = padded(q), padded(k), padded(v)
            if kv is not None:
                kv[0][:, :, :t].copy_(kp)
                kv[1][:, :, :t].copy_(vp)
            out = F.scaled_dot_product_attention(qp, kp, vp, is_causal=True, enable_gqa=True)
            out = out.transpose(1, 2).reshape(b * t, -1).index_select(0, lay.pad_rows)
        return self.o(out)

    def step(self, x: torch.Tensor, rope, positions: torch.Tensor, kv) -> torch.Tensor:
        """x (B, hidden), one new row a clip at `positions` (B,) -> (B,
        hidden), attending to the cache's rows 0 .. position."""
        q, k, v = self._split(x, rope)
        with annotate("attention"):
            ck, cv = kv
            rows = torch.arange(x.shape[0], device=x.device)
            ck[rows, :, positions] = k
            cv[rows, :, positions] = v
            seen = torch.arange(ck.shape[2], device=x.device)[None, :] <= positions[:, None]
            out = F.scaled_dot_product_attention(q[:, :, None], ck, cv,
                                                 attn_mask=seen[:, None, None, :],
                                                 enable_gqa=True)
        return self.o(out.reshape(x.shape[0], -1))


class DecoderLayer(nn.Module):
    def __init__(self, p: Mapping[str, Any], cfg: UniMoEConfig, dtype: torch.dtype,
                 held: Optional[Iterable[int]] = None):
        super().__init__()
        self.attn_norm = RMSNorm(p["attn_norm"], cfg.rms_eps)
        self.attn = GQAttention(p["attn"], cfg)
        self.moe_norm = RMSNorm(p["moe_norm"], cfg.rms_eps)
        self.moe = MoE(p, cfg, dtype, held)

    def _moe(self, h: torch.Tensor) -> torch.Tensor:
        y, routes = self.moe(rms_norm(h, self.moe_norm, torch.float32))
        h.add_(y)
        return routes

    def prefill(self, h: torch.Tensor, rope, lay: Layout, kv=None) -> torch.Tensor:
        """h (N, hidden) fp32, updated in place; returns the routes."""
        h.add_(self.attn.prefill(rms_norm(h, self.attn_norm), rope, lay, kv))
        return self._moe(h)

    def step(self, h: torch.Tensor, rope, positions: torch.Tensor, kv) -> torch.Tensor:
        h.add_(self.attn.step(rms_norm(h, self.attn_norm), rope, positions, kv))
        return self._moe(h)


class AudioLM(nn.Module):
    """The encoder, connector, decoder layers and head of one `UniMoEConfig`
    over a (possibly int8) parameter tree; build it with
    `model_from_params`."""

    def __init__(self, cfg: UniMoEConfig, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg.encoder_config, p["encoder"])
        self.connector = Linear(p["connector"])
        self.embed = frozen(p["embed"])
        self.blocks = nn.ModuleList()
        self.norm = RMSNorm(p["norm"], cfg.rms_eps)
        self.head = Linear(p["head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def audio_embeddings(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, 3000) -> (B, audio_tokens, hidden)."""
        feats = self.encoder(mel)
        with annotate("connector"):
            pooled = F.adaptive_avg_pool1d(feats.transpose(1, 2), self.cfg.audio_tokens)
            return self.connector(pooled.transpose(1, 2))

    def prefill(self, audio: torch.Tensor, lay: Layout,
                cache: Optional[List[KV]] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The packed rows through every layer: (h (N, hidden) fp32, each
        layer's routes (N, top_k) int8)."""
        n = len(lay.positions)
        h = torch.empty(n, self.cfg.hidden, dtype=torch.float32, device=self.device)
        h.index_copy_(0, lay.text_rows, self.embed.index_select(0, lay.text_ids).float())
        h.index_copy_(0, lay.audio_rows, audio.reshape(-1, self.cfg.hidden).float())
        rope = rope_tables(lay.positions, self.cfg.head_dim, self.cfg.rope_theta)
        routes = [blk.prefill(h, rope, lay, None if cache is None else cache[i])
                  for i, blk in enumerate(self.blocks)]
        return h, routes

    def step(self, tokens: torch.Tensor, positions: torch.Tensor,
             cache: List[KV]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One new token a clip (B,) at `positions` (B,) through every layer
        over the cache: (h (B, hidden) fp32, routes)."""
        h = self.embed.index_select(0, tokens).float()
        rope = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        routes = [blk.step(h, rope, positions, cache[i]) for i, blk in enumerate(self.blocks)]
        return h, routes

    def logprobs(self, h: torch.Tensor) -> torch.Tensor:
        """Rows h (R, hidden) fp32 -> log-probabilities (R, n_vocab) fp32:
        the final norm, the head's product in fp32 and its int8 scale, no
        rounding before the log-softmax."""
        with annotate("lm_head"):
            x = rms_norm(h, self.norm)
            w = self.head.w if self.head.w_q is None else self.head.w_q
            logits = scale_bias_cast(fp32_product(x, w), torch.float32,
                                     None if self.head.w_q is None else self.head.scale,
                                     self.head.b)
            return torch.log_softmax(logits, dim=-1)

    def new_cache(self, batch: int, capacity: int) -> List[KV]:
        """Each layer's rotated K and V, (batch, n_kv_head, capacity,
        head_dim) in the weights' dtype."""
        shape = (batch, self.cfg.n_kv_head, capacity, self.cfg.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.cfg.n_layer)]


def quantize_layer(p: Mapping[str, Any], min_size: int = MIN_QUANT_SIZE) -> dict:
    """One decoder layer's tree under the int8 rule, the router left as it is."""
    rest = {k: v for k, v in p.items() if k != "router"}
    return dict(quantize_params(rest, min_size=min_size), router=p["router"])


def model_from_params(cfg: UniMoEConfig, params: Mapping[str, Any], *,
                      quantize: Optional[str] = None, held: Optional[Iterable[int]] = None,
                      min_quant_size: int = MIN_QUANT_SIZE) -> AudioLM:
    """The model of a parameter tree {"encoder", "connector", "embed",
    "layers", "norm", "head"}, quantized if asked ("int8"), each layer read
    from `params["layers"]`, quantized and built before the next is read.
    `held`: the routed experts this model's MoE layers hold (all by
    default)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantize!r}")
    cfg.validate()
    top = {k: v for k, v in params.items() if k != "layers"}
    if quantize == "int8":
        top = dict(top, encoder=quantize_params(top["encoder"]),
                   **quantize_params({k: top[k] for k in ("connector", "head")},
                                     min_size=min_quant_size))
    model = AudioLM(cfg, top)
    layers = params["layers"]
    if len(layers) != cfg.n_layer:
        raise ValueError(f"{len(layers)} layers in the tree, {cfg.n_layer} in {cfg.name}")
    for i in range(cfg.n_layer):
        p = layers[i]
        if quantize == "int8":
            p = quantize_layer(p, min_quant_size)
        model.blocks.append(DecoderLayer(p, cfg, model.dtype, held))
        del p
    return model


class SeededLayers(abc.Sequence):
    """A model's decoder layers made from a seed when each is read: layer i
    from its own generator, so any layer can be made alone and again."""

    def __init__(self, cfg: UniMoEConfig, seed: int, dtype, device):
        self.cfg, self.seed, self.dtype, self.device = cfg, seed, dtype, torch.device(device)

    def __len__(self) -> int:
        return self.cfg.n_layer

    def __getitem__(self, i: int) -> dict:
        if not 0 <= i < len(self):
            raise IndexError(i)
        c = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 4099 + 1 + i) % (1 << 63))
        kw = dict(dtype=self.dtype, device=self.device)

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)

        def dense(fan_in, *shape, gain=1.0):
            return (normal(*shape) * (gain / math.sqrt(fan_in))).to(self.dtype)

        def small(*shape):
            return (0.02 * normal(*shape)).to(self.dtype)

        def scale(n):
            return (1.0 + small(n).float()).to(**kw)

        def swiglu(n, f):
            return {"gate_up": {"w": dense(c.hidden, n, c.hidden, 2 * f)},
                    "down": {"w": dense(f, n, f, c.hidden)}}

        h, nq, nk = c.hidden, c.n_head * c.head_dim, c.n_kv_head * c.head_dim
        return {
            "attn_norm": {"scale": scale(h)},
            "attn": {"q": {"w": dense(h, h, nq), "b": small(nq)},
                     "k": {"w": dense(h, h, nk), "b": small(nk)},
                     "v": {"w": dense(h, h, nk), "b": small(nk)},
                     "o": {"w": dense(nq, nq, h)}},
            "moe_norm": {"scale": scale(h)},
            # logits of standard deviation about 2 over unit-RMS rows: a
            # peaked router, as a trained one is
            "router": {"w": dense(h, h, c.n_routes, gain=2.0)},
            "experts": swiglu(c.n_experts, c.expert_ffn),
            "shared": swiglu(c.n_shared, c.shared_ffn),
        }


def init_params(cfg: UniMoEConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """Random weights of `cfg` from `seed` on `device`: the encoder as
    `params.init_params` makes Whisper's, the connector, embedding, final
    norm and head at fan-in scale, and `SeededLayers` for the decoder."""
    gen = torch.Generator(device=device).manual_seed(seed)
    enc = dataclasses.replace(cfg.encoder_config, n_text_layer=0, n_vocab=1)
    encoder = init_whisper_params(enc, gen, dtype=dtype, device=device)["encoder"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    h = cfg.hidden
    return {
        "encoder": encoder,
        "connector": {"w": (normal(cfg.n_audio_state, h) / math.sqrt(cfg.n_audio_state)).to(dtype),
                      "b": (0.02 * normal(h)).to(dtype)},
        "embed": (normal(cfg.n_vocab, h) / math.sqrt(h)).to(dtype),
        "layers": SeededLayers(cfg, seed, dtype, device),
        "norm": {"scale": (1.0 + 0.02 * normal(h)).to(dtype)},
        "head": {"w": (normal(h, cfg.n_vocab) / math.sqrt(h)).to(dtype)},
    }

