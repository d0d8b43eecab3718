"""LoRA adapters: low-rank fine-tuning on frozen (optionally int8) weights
(port of `lora.py`).

The runtime hook is `models.layers.linear`: a linear carrying `lora_a` /
`lora_b` adds `x @ A @ B` to its output, so every path (training, greedy
and beam decode, transcribe, serving) picks adapters up with no other
change. Training uses `TrainConfig(trainable="lora_")`: only the adapters
get gradients and optimizer moments (train.py).

The functions here work on JAX-layout parameter trees of tensors
(`params.params_tree`; layers stacked on axis 0): build the model again
from the adapted tree with `WhisperModel(cfg, tree)`. `merge_lora` and
`count_lora_params` also take a model.

The conventional alpha/rank factor is folded into A's initialisation, so
the adapter contribution is exactly `x @ A @ B` everywhere.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import torch

Params = Dict[str, Any]

# attention q/v projections (the LoRA-paper default target set), both self-
# and cross-attention
DEFAULT_TARGETS = r"(attn|cross_attn)/(q|v)$"


def _tree(params) -> Params:
    if isinstance(params, torch.nn.Module):
        from .params import params_tree

        return params_tree(params)
    return params


def add_lora(params: Params, *, rank: int = 8, alpha: float = 16.0,
             targets: str = DEFAULT_TARGETS, seed: int = 0,
             dtype: torch.dtype = torch.float32) -> Params:
    """Return the tree with LoRA adapters on every linear node whose path
    matches `targets` (stacked layer dims are kept: w (L, in, out) gets
    lora_a (L, in, r) and lora_b (L, r, out)), on the weights' device.

    A is drawn from a `torch.Generator` seeded with `seed`: its numbers
    differ from JAX's threefry draws for the same seed. B starts at zero,
    so the adapted model is identical to the base until training moves the
    adapters, in both packages."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    rx = re.compile(targets)
    gens: Dict[torch.device, torch.Generator] = {}
    added = 0

    def walk(node, path):
        nonlocal added
        if not isinstance(node, dict):
            return node
        if ("w" in node or "w_q" in node) and rx.search(path):
            w = node["w"] if "w" in node else node["w_q"]
            *lead, din, dout = w.shape
            gen = gens.setdefault(w.device, torch.Generator(device=w.device)
                                  .manual_seed(seed))
            a = torch.randn((*lead, din, rank), generator=gen,
                            dtype=torch.float32, device=w.device)
            # alpha/rank folded into A's init scale (see module docstring)
            a = (a * (alpha / rank) / math.sqrt(din)).to(dtype)
            new = dict(node)
            new["lora_a"] = a
            new["lora_b"] = torch.zeros((*lead, rank, dout), dtype=dtype,
                                        device=w.device)
            added += 1
            return new
        return {k: walk(v, f"{path}/{k}" if path else k)
                for k, v in node.items()}

    out = walk(params, "")
    if not added:
        raise ValueError(f"LoRA targets {targets!r} matched no linear nodes")
    return out


def merge_lora(params) -> Params:
    """Fold adapters into the base weights (w += A @ B, in fp32) and drop
    the adapter leaves. Quantized bases (w_q) cannot be merged: serve them
    unmerged (linear applies the adapter at run time) or merge before
    quantizing."""

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        if "lora_a" in node:
            if "w" not in node:
                raise ValueError(
                    f"cannot merge LoRA into quantized base at {path!r} "
                    "(w_q); merge before quantizing, or serve unmerged")
            delta = torch.einsum("...ir,...ro->...io", node["lora_a"].float(),
                                 node["lora_b"].float())
            new = {k: v for k, v in node.items()
                   if k not in ("lora_a", "lora_b")}
            new["w"] = (node["w"].float() + delta).to(node["w"].dtype)
            return new
        return {k: walk(v, f"{path}/{k}" if path else k)
                for k, v in node.items()}

    return walk(_tree(params), "")


def count_lora_params(params) -> int:
    """Number of adapter elements in a tree or a model."""
    from .utils.checkpoint import flatten_params

    return sum(v.numel() for k, v in flatten_params(_tree(params)).items()
               if k.rsplit("/", 1)[-1] in ("lora_a", "lora_b"))
