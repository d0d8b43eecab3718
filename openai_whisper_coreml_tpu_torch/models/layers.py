"""Core transformer layers (port of `models/layers.py`).

Parameterised parts are `nn.Module`s built from one layer's slice of the
parameter tree (see params.py); the math is plain functions on tensors,
with the JAX package's numerics:

  * layer norm and softmax in fp32 whatever the activation dtype;
  * products accumulate in fp32 (bf16 x bf16 products are exact in fp32,
    so upcasting the attention operands reproduces JAX's
    `preferred_element_type=float32`);
  * attention scales q and k each by D^-0.25 (openai numerics);
  * `self_attention(flash=True)` goes through `ops.flash_attention`, which
    launches the Hopper kernel on CUDA tensors (the encoder by default;
    the decoder's causal teacher forcing when training asks for it);
  * a linear carrying LoRA adapters (`lora_a`, `lora_b`) adds them at run
    time, on float and int8 bases (lora.py).

Weights are created frozen (Parameters that autograd ignores, so serving
builds no graph); training asks for the leaves it trains, and
`train.make_train_step`'s init turns `requires_grad` on for those only.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention


def frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    """An inference weight: a Parameter that autograd ignores (training
    turns `requires_grad` on for the leaves it trains)."""
    return None if t is None else nn.Parameter(t, requires_grad=False)


def layer_slice(tree: Mapping[str, Any], l: int) -> dict:
    """Layer l of a tree whose leaves are stacked on axis 0 (views)."""
    return {k: (layer_slice(v, l) if isinstance(v, Mapping) else v[l])
            for k, v in tree.items()}


LINEAR_LEAVES = ("w", "w_q", "scale", "b", "lora_a", "lora_b")


class Linear(nn.Module):
    """y = x @ w + b with w stored (in, out), or int8 `w_q` with a
    per-output-channel fp32 `scale` applied after the product; optional
    LoRA adapters `lora_a` (in, r) and `lora_b` (r, out)."""

    def __init__(self, p: Mapping[str, torch.Tensor]):
        super().__init__()
        unknown = set(p) - set(LINEAR_LEAVES)
        if unknown:
            raise ValueError(f"unknown linear leaves {sorted(unknown)}")
        for name in LINEAR_LEAVES:
            self.register_parameter(name, frozen(p.get(name)))
        if (self.w is None) == (self.w_q is None):
            raise ValueError(f"linear needs exactly one of w / w_q, got {sorted(p)}")
        if (self.lora_a is None) != (self.lora_b is None):
            raise ValueError(f"LoRA needs both lora_a and lora_b, got {sorted(p)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self)


class LayerNorm(nn.Module):
    def __init__(self, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.scale = frozen(p["scale"])
        self.bias = frozen(p["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self)


class MLP(nn.Module):
    def __init__(self, p: Mapping[str, Any]):
        super().__init__()
        self.fc1 = Linear(p["fc1"])
        self.fc2 = Linear(p["fc2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """q/k/v/out projections of one attention sublayer (k has no bias)."""

    def __init__(self, p: Mapping[str, Any], n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q = Linear(p["q"])
        self.k = Linear(p["k"])
        self.v = Linear(p["v"])
        self.out = Linear(p["out"])


def layer_norm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, output cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    if p.w_q is not None:
        # weights-only int8: dequantise to the activation dtype, scale after
        # the contraction (a plain product, as the JAX package leaves it to XLA)
        y = (x @ p.w_q.to(x.dtype)).float() * p.scale
    else:
        y = (x @ p.w.to(x.dtype)).float()
    if p.lora_a is not None:
        # the rank-r bottleneck, added in fp32 before the bias (JAX `linear`)
        xa = (x @ p.lora_a.to(x.dtype)).float()
        y = y + (xa.to(x.dtype) @ p.lora_b.to(x.dtype)).float()
    if p.b is not None:
        y = y + p.b.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as openai/whisper's F.gelu."""
    return F.gelu(x)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, n_state) -> (B, T, H, D)."""
    b, t, n = x.shape
    return x.reshape(b, t, n_head, n // n_head)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,Tq,H,D) x (B,Tk,H,D) attention, fp32 softmax; mask True = keep,
    broadcastable to (B, H, Tq, Tk)."""
    scale = q.shape[-1] ** -0.25
    qs = (q * scale).to(q.dtype)
    ks = (k * scale).to(k.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), ks.float())
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def self_attention(x: torch.Tensor, p: Attention, *, causal: bool = False,
                   flash: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (encoder, or causal decoder teacher
    forcing): `flash` takes `ops.flash_attention` (the kernel on the card),
    otherwise the plain `attention_core`, with a lower-triangular mask when
    causal (JAX `layers.self_attention`)."""
    q = split_heads(p.q(x), p.n_head)
    k = split_heads(p.k(x), p.n_head)
    v = split_heads(p.v(x), p.n_head)
    if flash:
        out = flash_attention(q, k, v, causal=causal)
    else:
        mask = None
        if causal:
            t = x.shape[1]
            mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        out = attention_core(q, k, v, mask=mask)
    return p.out(merge_heads(out))


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0,
              device: torch.device | str | None = None) -> torch.Tensor:
    """Sinusoidal position embedding (encoder), fp32 (length, channels)."""
    assert channels % 2 == 0
    # fp32 throughout, as the JAX package computes it (an fp64 increment
    # moves the angles at position 1500 by ~1e-4)
    log_inc = torch.log(torch.tensor(max_timescale, device=device)) / (channels // 2 - 1)
    inv = torch.exp(-log_inc * torch.arange(channels // 2, dtype=torch.float32,
                                            device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
