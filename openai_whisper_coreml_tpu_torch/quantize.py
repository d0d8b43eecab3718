"""Weights-only int8 quantisation for serving (port of `quantize.py`).

Per-output-channel int8: the scale is the absolute maximum over the
contraction axis (-2) divided by 127, and y = (x @ w_q) * scale. Conv
stems, embeddings, norms, biases and weights below MIN_QUANT_SIZE elements
stay in the float dtype. Quantised leaves are {"w_q", "scale"[, "b"]}, and
`models.layers.Linear` dispatches on them. `torch.round`, like
`jnp.round`, rounds half to even.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]

MIN_QUANT_SIZE = 1 << 16  # don't bother below 64k elements


def ieee_div(x, y) -> torch.Tensor:
    """x / y as one IEEE division, as XLA and the kernels divide; either may
    be a Python number. On a CUDA tensor PyTorch turns a division by a
    Python number into a product with its reciprocal, and `number / tensor`
    is a reciprocal times the number on any device: each rounds twice, and a
    scale one ulp off flips a rounded int8 value now and then. Dividing
    tensor by tensor rounds once on both devices."""
    ref = x if torch.is_tensor(x) else y
    x, y = (t if torch.is_tensor(t) else torch.full_like(ref, t) for t in (x, y))
    return torch.div(x, y)


def quantize_linear(w: torch.Tensor) -> Params:
    """(..., in, out) float weights -> int8 + per-output-channel fp32 scale.

    Stacked per-layer weights (L, in, out) get per-(layer, out) scales.
    """
    w32 = w.float()
    scale = ieee_div(w32.abs().amax(dim=-2, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"w_q": q, "scale": scale}


def quantize_params(params: Params, *, min_size: int = MIN_QUANT_SIZE) -> Params:
    """Quantise every eligible linear weight of a parameter tree. The size
    test counts the stacked (L, in, out) tensor, as the JAX package does."""
    non_linear = {"conv1", "conv2"}

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if "w" in node and not isinstance(node["w"], dict):
            w = node["w"]
            if (name not in non_linear and w.ndim in (2, 3)
                    and w.numel() >= min_size):
                out = quantize_linear(w)
                for extra in ("b", "lora_a", "lora_b"):
                    if extra in node:  # adapters ride along in float
                        out[extra] = node[extra]
                return out
            return node
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params)
