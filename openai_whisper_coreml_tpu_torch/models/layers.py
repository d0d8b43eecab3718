"""Core transformer layers (port of `models/layers.py`).

Parameterised parts are `nn.Module`s built from one layer's slice of the
parameter tree (see params.py); the math is plain functions on tensors,
with the JAX package's numerics:

  * layer norm and softmax in fp32 whatever the activation dtype;
  * products accumulate in fp32 (bf16 x bf16 products are exact in fp32,
    so upcasting the attention operands reproduces JAX's
    `preferred_element_type=float32`); every linear's product and the
    tied-embedding logits come out of `fp32_product` unrounded, and the
    scale, the LoRA term and the bias are added in fp32 before the one
    cast at the end;
  * attention scales q and k each by D^-0.25 (openai numerics);
  * `self_attention(flash=True)` goes through `ops.flash_attention`, which
    launches the Hopper kernel on CUDA tensors (the encoder by default;
    the decoder's causal teacher forcing when training asks for it);
  * a linear carrying LoRA adapters (`lora_a`, `lora_b`) adds them at run
    time, on float and int8 bases (lora.py).

Weights are created frozen (Parameters that autograd ignores, so serving
builds no graph); training asks for the leaves it trains, and
`train.make_train_step`'s init turns `requires_grad` on for those only.

Under a (data, model) mesh (`parallel/`) the attention and MLP linears
are `ParallelLinear`s over this rank's shard: column-parallel (q, k, v,
fc1: local output columns, so local heads) or row-parallel (out, fc2:
local input rows; each rank's partial product is taken in fp32
(`fp32_product`), all-reduced over the model group unrounded and the bias
added after the sum, as GSPMD runs JAX's `dot(x, w) + b`). Training
goes through Megatron's pair of communication ops, written by hand as
autograd Functions (`copy_to_model`, `reduce_from_model`); at inference
they are a no-op and a plain in-place all-reduce. Without a mesh every
module is the plain `Linear`: no collective, no extra op per call.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist
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


# -- tensor-parallel communication ---------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in fp32 (gloo's dtypes; exact for the zero-filled
    gathers, and the partial products are fp32 already). In place for an
    fp32 tensor."""
    if x.dtype == torch.float32:
        dist.all_reduce(x, group=group)
        return x
    y = x.float()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward
    (the input of a column-parallel product, whose input gradient is a
    partial sum on each rank)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axis.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward (the output of a
    row-parallel product; the loss downstream is one replicated term, so
    the gradient must not be summed again, as
    `torch.distributed.nn.functional.all_reduce` would)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x.clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` forward (`gather_model`), this rank's slice of
    the gradient backward (the gradient of a replicated activation is
    whole on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.width = dim, axis, x.shape[dim]
        return gather_model(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis) if _tracks_grad(x) else x


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of the model group's partial products (fp32)."""
    if _tracks_grad(x):
        return _ReduceFromModel.apply(x, axis)
    return _all_reduce(x, axis.group)


def gather_dim(x: torch.Tensor, dim: int, group, rank: int, size: int) -> torch.Tensor:
    """Concatenate the group's equal slices along `dim`, in rank order: a
    zero-filled full buffer that each rank writes its slice into, summed
    over the group (gloo has no all_gather for CUDA tensors; x + 0 = x, so
    the sum is exact)."""
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * size
    full = torch.zeros(shape, dtype=torch.float32, device=x.device)
    full.narrow(dim, rank * width, width).copy_(x)
    return _all_reduce(full, group).to(x.dtype)


def gather_model(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The model group's shards of one tensor, whole (differentiable)."""
    if _tracks_grad(x):
        return _GatherFromModel.apply(x, dim, axis)
    return gather_dim(x, dim, axis.group, axis.rank, axis.size)


class ParallelLinear(Linear):
    """A `Linear` over this rank's shard of the weight.

    "col": the output columns [r*n, (r+1)*n) of w (and of the bias and the
    int8 scale); the input is replicated. "row": the input rows of w; the
    input is this rank's slice of the features, the products are taken in
    fp32 (`fp32_product`) and summed over the model group before the
    scale and the bias. LoRA adapters stay whole (JAX replicates them): a
    column-parallel linear uses its columns of `lora_b`, a row-parallel one
    its rows of `lora_a`, whose partial product is summed in fp32 before
    the cast and `@ lora_b` (in fp32 too, as JAX's).
    `partial_grads` names the leaves whose gradient on one rank is a part
    of the whole and must be summed over the model group (train.py)."""

    def __init__(self, p: Mapping[str, torch.Tensor], axis, mode: str):
        super().__init__(p)
        if mode not in ("col", "row"):
            raise ValueError(f"unknown parallel mode {mode!r}")
        self.axis, self.mode = axis, mode
        self.partial_grads = (("lora_a", "lora_b") if mode == "col"
                              else ("lora_a",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w if self.w_q is None else self.w_q
        if self.mode == "col":
            x = copy_to_model(x, self.axis)
            y = fp32_product(x, w)
        else:
            y = reduce_from_model(fp32_product(x, w), self.axis)
        if self.w_q is not None:
            y = y * self.scale
        if self.lora_a is not None:
            a, b = self.lora_a, self.lora_b
            if self.mode == "col":
                n = w.shape[-1]
                b = b[:, self.axis.rank * n:(self.axis.rank + 1) * n]
                xa = fp32_product(x, a)
            else:
                n = w.shape[0]
                a = a[self.axis.rank * n:(self.axis.rank + 1) * n]
                xa = reduce_from_model(fp32_product(x, a), self.axis)
            y = y + fp32_product(xa.to(x.dtype), b)
        if self.b is not None:
            y = y + self.b.float()
        return y.to(x.dtype)


def fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in fp32 with no rounding before the result, JAX's
    `dot(..., preferred_element_type=float32)`: w is cast to x's dtype
    first (int8 codes are exact in bf16). On the card a bf16 or fp16
    product is one GEMM with an fp32 output (`aten::mm.dtype`, the
    activations flattened to 2-D); elsewhere, and for fp32, the operands
    are upcast (a bf16 x bf16 product is exact in fp32; fp32 is left as
    it is)."""
    w = w.to(x.dtype)
    if not (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)):
        return x.float() @ w.float()
    x2d = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _Fp32Product.apply(x2d, w)
    else:
        y = torch.mm(x2d, w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _Fp32Product(torch.autograd.Function):
    """`aten::mm.dtype` for training, which has no derivative of its own:
    the backward takes the half-precision products that `(x @ w).float()`
    would (the fp32 gradient cast to the operands' dtype)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                x.T @ g if ctx.needs_input_grad[1] else None)


def make_linear(p: Mapping[str, torch.Tensor], axis, mode: str) -> Linear:
    """The plain `Linear` without a mesh, else a `ParallelLinear`."""
    return Linear(p) if axis is None else ParallelLinear(p, axis, mode)


class LayerNorm(nn.Module):
    def __init__(self, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.scale = frozen(p["scale"])
        self.bias = frozen(p["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self)


class MLP(nn.Module):
    def __init__(self, p: Mapping[str, Any], axis=None):
        super().__init__()
        self.fc1 = make_linear(p["fc1"], axis, "col")
        self.fc2 = make_linear(p["fc2"], axis, "row")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """q/k/v/out projections of one attention sublayer (k has no bias).
    Under a model axis of size m, `n_head` is this rank's n_head / m heads."""

    def __init__(self, p: Mapping[str, Any], n_head: int, axis=None):
        super().__init__()
        self.n_head = n_head if axis is None else n_head // axis.size
        self.q = make_linear(p["q"], axis, "col")
        self.k = make_linear(p["k"], axis, "col")
        self.v = make_linear(p["v"], axis, "col")
        self.out = make_linear(p["out"], axis, "row")


def layer_norm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, output cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """JAX's `linear`: the product in fp32, then (int8) the per-output-channel
    scale, the LoRA bottleneck and the bias, added in fp32 before one cast
    to x's dtype."""
    y = fp32_product(x, p.w if p.w_q is None else p.w_q)
    if p.w_q is not None:
        y = y * p.scale
    if p.lora_a is not None:
        # the rank-r bottleneck, rounded to x's dtype as JAX rounds it
        xa = fp32_product(x, p.lora_a)
        y = y + fp32_product(xa.to(x.dtype), p.lora_b)
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
